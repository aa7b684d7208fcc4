// The gate rows of one chunk of the v2 kernels (csrc/chunkwise_fw.cu,
// csrc/chunkwise_bw.cu), computed in the kernel from the raw gate
// pre-activations: the TPU kernels take them precomputed by XLA
// (`_pack_gates`, xlstm_yolo_tpu/ops/pallas/chunkwise_v2.py:259).
#pragma once

#include <math_constants.h>

namespace v2 {

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// b (inclusive cumsum of logsig(f) over the chunk, rows at or past `valid`
// adding 0), e^b and, given ir, logsig(i) (-inf past `valid`) and
// e^{(g - b) + logsig(i)}, g = b[L - 1], for the L rows of one chunk whose
// raw gates are fr, ir.  Warp 0, two rows a lane; the caller synchronises.
__device__ __forceinline__ void chunk_gates(const float* fr, const float* ir, int valid,
                                            float* sb, float* seb, float* sli, float* sea) {
  const int lane = threadIdx.x & 31;
  const int r0 = 2 * lane, r1 = r0 + 1;
  const float lf0 = r0 < valid ? log_sigmoid(fr[r0]) : 0.f;
  const float lf1 = r1 < valid ? log_sigmoid(fr[r1]) : 0.f;
  float incl = lf0 + lf1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float b0 = excl + lf0, b1 = b0 + lf1;
  sb[r0] = b0;
  sb[r1] = b1;
  seb[r0] = expf(b0);
  seb[r1] = expf(b1);
  if (ir) {
    const float g = __shfl_sync(0xffffffffu, b1, 31);
    const float li0 = r0 < valid ? log_sigmoid(ir[r0]) : -CUDART_INF_F;
    const float li1 = r1 < valid ? log_sigmoid(ir[r1]) : -CUDART_INF_F;
    sli[r0] = li0;
    sli[r1] = li1;
    sea[r0] = expf((g - b0) + li0);
    sea[r1] = expf((g - b1) + li1);
  }
}

}  // namespace v2
