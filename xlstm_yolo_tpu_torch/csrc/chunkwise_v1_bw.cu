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
// Design.  The dC scan runs in two passes (chunkwise_v1.cuh launch_dc):
// dc_inc_kernel makes every chunk's increment R(qbar)^T R(dhn) at once, a
// block of 4 warps per (min(DH, 64) rows of dC, chunk, batch * head) on the
// tensor cores, into the dC slots it leaves for them; dc_combine_kernel
// then walks the chunks in reverse, dC_{k-1} = e^{g_k} dC_k + increment_k,
// elementwise in float32 (e^{g_k} from a (B * NH, NC) scratch the first
// pass fills).  The dq/dk/dv kernel is independent per (batch * head,
// chunk): dqkv_kernel (chunkwise_v1.cuh), every (batch * head, chunk,
// 64-row sub-tile, part) a block of 4 warps, part 0 computing dq of the
// sub-tile's rows (walking the key sub-tiles at or before it) and part 1 dk
// and dv of its rows as keys (walking the query sub-tiles at or after it),
// so a chunk of 512 rows needs no (512 x 512) tile in shared memory.  It is
// the quadratic backward confined to a chunk plus the state products: each
// warp owns 16 rows, makes its state product(s) on the tensor cores, then
// takes the other side's sub-tiles, staged two deep by cp.async, through
// the quadratic kernels' tile steps (par::dq_step, par::dkv_step in
// parallel.cuh: mma.sync m16n8k16 in bf16 with the score fragment kept in
// registers and one exp a causal pair; float32 FMA in the same layout with
// float32 products).  Blocks go heaviest first.
//
// What bounds it.  The pair moves q, k, v, dh, dq, dk, dv once, the gates,
// den and the states per chunk: bound by bytes (PERF.md; the dC scan
// writes its states, and the combine reads and writes them again).  The kernel
// also takes one exp a causal pair of a chunk in each part, B NH S (L + 1)
// / 2 of them, and recomputes P in both parts; PERF.md holds its times
// beside the bound and the exps' floor.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "chunkwise_v1.cuh"

using namespace v1;

// dtype, cdtype: 0 = float32, 1 = bfloat16 (storage of q and dh; compute
// type of the products).  den (B, NH, S) from chunkwise_v1_fw; dc_last
// (B, NH, DH, DH) may be null.  Outputs dc_states (B, NH, NC, DH, DH) and
// dc0 (B, NH, DH, DH) float32; gbar is a (B, NH, NC) float32 scratch.
// Returns a CUDA error code; 1000 for a dtype, head size or chunk the
// kernels do not take.
extern "C" int chunkwise_v1_bw_dc(const void* q, const float* f, const void* dh,
                                  const float* den, const float* dc_last, float* dc_states,
                                  float* dc0, float* gbar, int B, int NH, int S, int DH, int L,
                                  int dtype, int cdtype, float qk_scale, float eps, void* stream) {
  if (!chunk_ok(S, L)) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dhd) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dhd)::value;
    return launch_dc<T, CT, D, false>(static_cast<const T*>(q), static_cast<const T*>(dh), f, den,
                                      dc_last, dc_states, dc0, gbar, B * NH, S, L, qk_scale, eps,
                                      MState{}, st);
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
    return launch_dqkv<T, CT, D, false, float>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), i, f,
        c_states, den, static_cast<const T*>(dh), dc_states, dq, dk, dv, B * NH, S, L, qk_scale,
        eps, MState{}, st);
  });
}
