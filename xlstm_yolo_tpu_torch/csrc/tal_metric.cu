// Fused metric stage of the task-aligned assigner for Hopper, sm_90a.
//
// Replaces the TPU kernel `_kernel` (xlstm_yolo_tpu/ops/pallas/
// tal_metric.py:39, launched by `tal_metric_pallas` :116, call :167).  Per
// (image b, gt m), over the A anchors:
//
//   valid  = anchor centre strictly inside gt m (by more than eps) and mask_gt
//   ov     = valid ? max(CIoU(gt, pred), 0) : 0
//   align  = sqrt(valid ? score[b, a, cls[m]] : 0) * ((ov^2 * ov^2) * ov^2)
//   pos    = valid and a among the top-k of the row's align (k rounds of row
//            max, the lowest index among ties; k = min(topk, k[b]))
//
// The CIoU follows the Pallas kernel's expression operation for operation,
// and every product, sum, quotient and root here is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn): nvcc would
// otherwise contract a*b + c into one FMA, and a metric one ulp away from
// the plain version's can flip a selection at the k-th place.  The atan
// terms of the aspect ratio come from the wrapper, one torch op shared with
// the plain version.
//
// Design.  One block of 256 threads per (image, gt) row.  The threads walk
// the anchors with a stride of 256, write the row's align and overlaps, and
// keep align (float) and valid (a byte) in shared memory: 5 A bytes, 42 KB
// at A = 8400 (640 px).  The top-k is k block-wide arg-max reductions over
// that copy, ordered by value, then by the lowest index (the order of the
// Pallas kernel's max + min-index-of-ties); each winner is set to -inf and
// marked selected.  The gt's class column of the scores is read directly,
// with a stride of nc floats (through L2: the (B, A, nc) scores are 21.5 MB
// at B 8, nc 80).
//
// What bounds it.  Bytes: the gathered scores (B M A floats), the boxes,
// anchors and gts read once and the three (B, M, A) outputs written once,
// 77 MB of outputs at B 8, M 128, A 8400: 23 us at 3.35 TB/s.  The
// operations (~60 flop an element) are far below the card's rate.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

using namespace port;

namespace {

struct Best {
  float v;
  int i;
};

// The better of two candidates: the larger value, the lower index on a tie.
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__global__ void __launch_bounds__(NT) tal_metric_kernel(
    const float* __restrict__ scores, const float* __restrict__ pbox,
    const float* __restrict__ anc, const int* __restrict__ cls, const float* __restrict__ gbox,
    const uint8_t* __restrict__ mask_gt, const float* __restrict__ atan_p,
    const float* __restrict__ atan_g, const int* __restrict__ karr, float* __restrict__ metric,
    float* __restrict__ overlaps, uint8_t* __restrict__ pos, int M, int A, int nc, int topk,
    float eps, float eps7, float four_pi2, float one_eps7) {
  extern __shared__ float smem[];
  float* live = smem;                                       // (A) align, winners -inf
  uint8_t* flag = reinterpret_cast<uint8_t*>(smem + A);     // (A) bit 0 valid, bit 1 selected
  __shared__ Best warp_best[NT / 32];

  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;  // b * M + m
  const int b = static_cast<int>(row / M);
  const float gx1 = gbox[row * 4 + 0], gy1 = gbox[row * 4 + 1];
  const float gx2 = gbox[row * 4 + 2], gy2 = gbox[row * 4 + 3];
  const float ag = atan_g[row];
  const bool gt_ok = mask_gt[row] != 0;
  const int c = cls[row];
  const bool has_cls = c < nc;
  const float w1 = __fsub_rn(gx2, gx1);
  const float h1 = __fadd_rn(__fsub_rn(gy2, gy1), eps7);
  const float area1 = __fmul_rn(w1, h1);
  const size_t out0 = row * (size_t)A;

  for (int a = tid; a < A; a += NT) {
    const float ax = anc[2 * a], ay = anc[2 * a + 1];
    const bool valid = gt_ok && __fsub_rn(ax, gx1) > eps && __fsub_rn(ay, gy1) > eps &&
                       __fsub_rn(gx2, ax) > eps && __fsub_rn(gy2, ay) > eps;
    const size_t p = ((size_t)b * A + a) * 4;
    const float px1 = pbox[p], py1 = pbox[p + 1], px2 = pbox[p + 2], py2 = pbox[p + 3];
    const float w2 = __fsub_rn(px2, px1);
    const float h2 = __fadd_rn(__fsub_rn(py2, py1), eps7);
    const float iw = fmaxf(__fsub_rn(fminf(gx2, px2), fmaxf(gx1, px1)), 0.f);
    const float ih = fmaxf(__fsub_rn(fminf(gy2, py2), fmaxf(gy1, py1)), 0.f);
    const float inter = __fmul_rn(iw, ih);
    const float uni =
        __fadd_rn(__fsub_rn(__fadd_rn(area1, __fmul_rn(w2, h2)), inter), eps7);
    const float iou = __fdiv_rn(inter, uni);
    const float cw = __fsub_rn(fmaxf(gx2, px2), fminf(gx1, px1));
    const float ch = __fsub_rn(fmaxf(gy2, py2), fminf(gy1, py1));
    const float c2 = __fadd_rn(__fadd_rn(__fmul_rn(cw, cw), __fmul_rn(ch, ch)), eps7);
    const float dx = __fsub_rn(__fsub_rn(__fadd_rn(px1, px2), gx1), gx2);
    const float dy = __fsub_rn(__fsub_rn(__fadd_rn(py1, py2), gy1), gy2);
    const float rho2 = __fmul_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), 0.25f);
    const float dv = __fsub_rn(atan_p[(size_t)b * A + a], ag);
    const float v = __fmul_rn(four_pi2, __fmul_rn(dv, dv));
    const float alpha = __fdiv_rn(v, __fadd_rn(__fsub_rn(v, iou), one_eps7));
    const float ciou = __fsub_rn(iou, __fadd_rn(__fdiv_rn(rho2, c2), __fmul_rn(v, alpha)));
    // clamp at 0 as torch.clamp and jnp.maximum do (a NaN stays NaN)
    const float ov = valid ? (ciou < 0.f ? 0.f : ciou) : 0.f;
    const float s = (valid && has_cls) ? scores[((size_t)b * A + a) * nc + c] : 0.f;
    const float ov2 = __fmul_rn(ov, ov);
    const float al = __fmul_rn(__fsqrt_rn(s), __fmul_rn(__fmul_rn(ov2, ov2), ov2));
    metric[out0 + a] = al;
    overlaps[out0 + a] = ov;
    live[a] = al;
    flag[a] = valid ? 1 : 0;
  }
  __syncthreads();

  const int k = min(topk, karr[b]);
  for (int r = 0; r < k; ++r) {
    Best best{-CUDART_INF_F, 0x7fffffff};
    for (int a = tid; a < A; a += NT) best = better(best, Best{live[a], a});
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      Best other{__shfl_down_sync(0xffffffffu, best.v, o),
                 __shfl_down_sync(0xffffffffu, best.i, o)};
      best = better(best, other);
    }
    if ((tid & 31) == 0) warp_best[tid >> 5] = best;
    __syncthreads();
    if (tid == 0) {
      Best w = warp_best[0];
#pragma unroll
      for (int j = 1; j < NT / 32; ++j) w = better(w, warp_best[j]);
      live[w.i] = -CUDART_INF_F;
      flag[w.i] |= 2;
    }
    __syncthreads();
  }
  for (int a = tid; a < A; a += NT) pos[out0 + a] = flag[a] == 3 ? 1 : 0;
}

}  // namespace

// scores (B, A, nc), pbox (B, A, 4), anc (A, 2), cls (B, M) int32 (clipped
// to [0, num_classes)), gbox (B, M, 4), mask_gt (B, M) bytes, atan_p (B, A),
// atan_g (B, M), karr (B) int32: float32 unless named.  eps7, four_pi2 =
// 4 / pi^2 and one_eps7 = 1 + eps7 are the Python floats of the plain
// version rounded once to float32, as its torch ops round them.  Outputs
// metric and overlaps (B, M, A) float32, pos (B, M, A) bytes.  Returns a CUDA error
// code; 1000 for shapes the kernel does not take.
extern "C" int tal_metric(const float* scores, const float* pbox, const float* anc,
                          const int* cls, const float* gbox, const uint8_t* mask_gt,
                          const float* atan_p, const float* atan_g, const int* karr,
                          float* metric, float* overlaps, uint8_t* pos, int B, int M, int A,
                          int nc, int topk, float eps, float eps7, float four_pi2,
                          float one_eps7, void* stream) {
  if (B <= 0 || M <= 0 || A <= 0 || nc <= 0) return 1000;
  const size_t smem = (size_t)A * (sizeof(float) + 1);
  if (smem > 232448 - sizeof(Best) * (NT / 32)) return 1000;
  return launch_with_smem(tal_metric_kernel, dim3((unsigned)(B * M)), smem,
                          static_cast<cudaStream_t>(stream), scores, pbox, anc, cls, gbox,
                          mask_gt, atan_p, atan_g, karr, metric, overlaps, pos, M, A, nc, topk,
                          eps, eps7, four_pi2, one_eps7);
}
