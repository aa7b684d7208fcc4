// Chunkwise sigmoid-input-gate mLSTM forward, the v1 route, for Hopper,
// sm_90a.
//
// Replaces the TPU kernel `_fw_kernel` (xlstm_yolo_tpu/ops/pallas/
// chunkwise.py:96, launched by `_fw` :182, call :220).  Per chunk k of L
// rows, with b = cumsum logsig(f), a = (b_last - b) + logsig(i),
// g = b_last, D = tril(e^{b_l - b_j + logsig(i_j)}), qbar = q e^b scale:
//
//   c_states[k] = C_{k-1},  n_states[k] = n_{k-1}   (the state before the chunk)
//   h   = (R(qbar) R(C_{k-1}) + R(R(q) R(k)^T scale * D) R(v)) / (den + eps)
//   den = max(|qbar . n_{k-1} + rowsum(R(q) R(k)^T scale * D)|, 1)
//   C_k = e^g C_{k-1} + R(k e^a)^T R(v),   n_k = e^g n_{k-1} + sum_l k_l e^{a_l}
//
// and c_last, n_last after the last chunk.  R() rounds to the compute type
// (bfloat16 by default) where the TPU kernel casts (`:131, 142, 151, 167`);
// sums are float32.  The chunk length is the caller's, and the kernel keeps
// it: the rounding points and the saved states are per chunk.
//
// Design.  The TPU runs its grid in order and fuses the whole forward into
// one kernel that carries (C, n) in VMEM (`chunkwise.py:7-11`).  Hopper's
// blocks run in no order, so the forward is two launches of the kernels of
// chunkwise_v1.cuh (launch_fw), their products in the mma fragment layout
// (tc::prod16): mma.sync m16n8k16 with bf16 operands and float32 sums for
// bf16 products, float32 FMA in the same tiling for float32 products.
//   1. fw_scan_kernel, the state pass: a block of 4 warps per (batch *
//      head, 16 rows of C), B NH DH / 16 blocks, walks the chunks in 64-row
//      tiles with C's rows in float32 registers (the accumulator layout);
//      per chunk it stores the state before it, then adds
//      e^g C + R(kbar[:, rows])^T R(v) on the mma, while the next tile's k
//      columns, v and gates load by cp.async.
//   2. fw_h_kernel, the output pass: every (batch * head, chunk, 64-row
//      sub-tile) is a block of 4 warps of 16 rows (B NH S / 64 blocks),
//      heaviest first.  A warp stages R(qbar) of its rows and makes
//      R(qbar) R(C_prev) on the mma, then walks the chunk's key sub-tiles up
//      to its own, two deep by cp.async, as the quadratic forward walks its
//      key tiles (parallel_fw.cu): the (16 x 64) score fragment is scaled by
//      D in registers, one exp a pair, summed for den and fed, packed to
//      bf16, to the product with R(v).  A 512-row chunk never needs its
//      (512 x 512) score tile.
//
// What bounds it.  The function moves q, k, v and h once, the gates, and
// the states per chunk (B * NH * NC * (DH + 1) * DH floats): bound by bytes
// at every L (PERF.md holds its times beside the bound).  It also takes one
// exp a causal pair of a chunk, B NH S (L + 1) / 2 of them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "chunkwise_v1.cuh"

using namespace v1;

// dtype, cdtype: 0 = float32, 1 = bfloat16 (storage of q, k, v, h; compute
// type of the products).  c0 / n0 may be null (zero initial state).  Outputs:
// h (B, NH, S, DH) in the storage type; den (B, NH, S), c_states
// (B, NH, NC, DH, DH), n_states (B, NH, NC, DH), c_last (B, NH, DH, DH),
// n_last (B, NH, DH) float32.  Returns a CUDA error code; 1000 for a dtype,
// head size or chunk the kernels do not take.
extern "C" int chunkwise_v1_fw(const void* q, const void* k, const void* v, const float* i,
                               const float* f, const float* c0, const float* n0, void* h,
                               float* den, float* c_states, float* n_states, float* c_last,
                               float* n_last, int B, int NH, int S, int DH, int L, int dtype,
                               int cdtype, float qk_scale, float eps, void* stream) {
  if (!chunk_ok(S, L)) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dh) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dh)::value;
    return launch_fw<T, CT, D, false>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), i, f, c0,
        n0, static_cast<T*>(h), den, c_states, n_states, c_last, n_last, B * NH, S, L, qk_scale,
        eps, MState{}, st);
  });
}
