// Chunkwise sigmoid-input-gate mLSTM backward, the v1 route, for Hopper,
// sm_90a: two kernels, as on the TPU.
//
// Replaces the TPU kernels `_bw_dc_kernel` (xlstm_yolo_tpu/ops/pallas/
// chunkwise.py:271, call :431) and `_bw_dqkv_kernel` (:316, call :463),
// both launched by `_bw` :397.  The denominator den = max(|.|, 1) saved by
// the forward is a constant, as in the Pallas VJP.  With dhn = dh / (den +
// eps), qbar = q e^b scale, D = tril(e^{b_l - b_j + logsig(i_j)}) and R()
// the rounding to the compute type at the TPU kernels' casts (`:305, 342,
// 348, 359, 364, 372, 377, 385, 390`):
//
//   chunkwise_v1_bw_dc:   dC_{k-1} = e^g dC_k + R(qbar_k)^T R(dhn_k), walking
//                         the chunks in reverse from dC_last (or zeros);
//                         dc_states[k] = dC_k, the gradient of the state
//                         after chunk k, and dc0 = dC_{-1};
//   chunkwise_v1_bw_dqkv: per chunk, from c_states[k] = C_{k-1} and dC_k,
//                         P  = (R(dhn) R(v)^T) * D,  SD = (R(q) R(k)^T scale) * D
//                         dq = R(P) R(k) scale + (R(dhn) R(C_{k-1})^T) e^b scale
//                         dk = R(P)^T R(q) scale + (R(v) R(dC_k)^T) e^a
//                         dv = R(SD)^T R(dhn) + R(k e^a) R(dC_k)
//
// in float32; the wrapper computes the gate gradients from dq and dk and
// casts them, as `_bw` does.
//
// Design.  The dC scan is the serial part: state_scan_kernel
// (chunkwise_v1.cuh), one block per (batch, head), a (L x DH)^T (L x DH)
// product per chunk.  The dq/dk/dv kernel is independent per (batch * head,
// chunk): dqkv_kernel (chunkwise_v1.cuh), every (batch * head, chunk,
// 64-row sub-tile, part) a block, part 0 computing dq of the sub-tile's rows
// (walking the key sub-tiles at or before it) and part 1 dk and dv of its
// rows as keys (walking the query sub-tiles at or after it), so a chunk of
// 512 rows needs no (512 x 512)
// tile in shared memory.  2 * 96 * S / 64 blocks at batch 8 fill the card.
// At DH = 128 the sub-tiles have 32 rows (`dqkv_rows`), so that a block's
// operands fit in 163 KB of shared memory; the sums run over the same terms
// in the same order, so the numbers do not change.
// Products are float32 FMA on the CUDA cores with rounded operands.
//
// What bounds it.  The pair moves q, k, v, dh, dq, dk, dv once, the gates,
// den and the states per chunk: bound by bytes (PERF.md).  This first
// version recomputes the (L x L) tiles in float32 FMA, whose work grows
// with L; PERF.md holds its times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "chunkwise_v1.cuh"

using namespace v1;

// dtype, cdtype: 0 = float32, 1 = bfloat16 (storage of q and dh; compute
// type of the products).  den (B, NH, S) from chunkwise_v1_fw; dc_last
// (B, NH, DH, DH) may be null.  Outputs dc_states (B, NH, NC, DH, DH) and
// dc0 (B, NH, DH, DH) float32.  Returns a CUDA error code; 1000 for a
// dtype, head size or chunk the kernels do not take.
extern "C" int chunkwise_v1_bw_dc(const void* q, const float* f, const void* dh,
                                  const float* den, const float* dc_last, float* dc_states,
                                  float* dc0, int B, int NH, int S, int DH, int L, int dtype,
                                  int cdtype, float qk_scale, float eps, void* stream) {
  if (!chunk_ok(S, L)) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dhd) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dhd)::value;
    return launch_with_smem(state_scan_kernel<T, CT, D, true, false>, dim3(B * NH),
                            sizeof(float) * scan_smem_floats<D>(), st, static_cast<const T*>(q),
                            static_cast<const T*>(dh), nullptr, f, den, dc_last, nullptr,
                            dc_states, nullptr, dc0, nullptr, S, L, qk_scale, eps, MState{});
  });
}

// The same types; c_states from chunkwise_v1_fw, dc_states from
// chunkwise_v1_bw_dc.  Outputs dq, dk, dv (B, NH, S, DH) float32.
extern "C" int chunkwise_v1_bw_dqkv(const void* q, const void* k, const void* v, const float* i,
                                    const float* f, const float* c_states, const float* den,
                                    const void* dh, const float* dc_states, float* dq, float* dk,
                                    float* dv, int B, int NH, int S, int DH, int L, int dtype,
                                    int cdtype, float qk_scale, float eps, void* stream) {
  if (!chunk_ok(S, L)) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dhd) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dhd)::value;
    const dim3 grid((S / L) * (L / tile_rows(L, dqkv_rows<D>())), B * NH, 2);
    return launch_with_smem(dqkv_kernel<T, CT, D, false, float>, grid,
                            sizeof(float) * dqkv_smem_floats<D>(), st, static_cast<const T*>(q),
                            static_cast<const T*>(k), static_cast<const T*>(v), i, f, c_states,
                            den, static_cast<const T*>(dh), dc_states, dq, dk, dv, S, L,
                            qk_scale, eps, MState{});
  });
}
