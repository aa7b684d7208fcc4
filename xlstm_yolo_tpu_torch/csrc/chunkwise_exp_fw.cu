// Chunkwise exponential-input-gate mLSTM forward with the max stabilizer m,
// for Hopper, sm_90a.
//
// Replaces the TPU kernel `_fw_kernel` (xlstm_yolo_tpu/ops/pallas/
// chunkwise_exp.py:55), launched by `_fw` :161 with the saved rows in
// training (call :210) and without them in predict (call :248).  Per chunk
// k of L rows, with b = cumsum logsig(f), g = b_last, a = (g - b) + i (the
// raw input gate), m_prev the stabilizer before the chunk and
//   m_comb_l = max(b_l + m_prev, max_{j <= l} ((b_l - b_j) + i_j)),
//   D        = tril(e^{((b_l - b_j) + i_j) - m_comb_l}),
//   qbar     = q e^{(b + m_prev) - m_comb} scale:
//
//   h   = (R(qbar) R(C_{k-1}) + R(R(q) R(k)^T scale * D) R(v)) / (den + eps)
//   den = max(|qbar . n_{k-1} + rowsum(R(q) R(k)^T scale * D)|, e^{-m_comb})
//   m_k = max(g + m_prev, max_l a_l),  gbar = e^{(g + m_prev) - m_k}
//   C_k = gbar C_{k-1} + R(k e^{a - m_k})^T R(v),  n_k = gbar n_{k-1} + sum_l k_l e^{a_l - m_k}
//
// C and n are stored relative to m.  R() rounds to the compute type
// (bfloat16 by default) where the TPU kernel casts (`:99-115, :129-133`);
// sums are float32, the row sums unrounded.  The training variant also
// writes den and m_comb of every row; both write C, n, m before each chunk
// (the backward's saved C and m) and the last (C, n, m).
//
// Design.  The TPU fuses the forward into one serial grid (`BNH`, `NC`)
// that carries (C, n, m) in VMEM.  Here, as on the v1 route, two launches
// of the kernels of chunkwise_v1.cuh with the exp gate (launch_fw), on the
// tensor cores for bf16 products (float32 FMA in the same tiling for
// float32 products):
//   1. fw_scan_kernel, the state pass: a block of 4 warps per (batch *
//      head, 16 rows of C).  A chunk's keys are rounded after their scaling
//      by e^{a - m_new}, and m_new depends on the m before the chunk, so no
//      increment can be taken ahead against another stabilizer: every block
//      of a head computes the same m from the gates alone (warp 0 takes the
//      max of a over the chunk), one writes it, and each block adds
//      gbar C + R(kbar[:, rows])^T R(v) on the mma in 64-row tiles.
//   2. fw_h_kernel, the output pass: every (batch * head, chunk, 64-row
//      sub-tile) is a block of 4 warps of 16 rows, walking the chunk's key
//      sub-tiles on the mma as on the v1 route.  The trap: m_comb of row l
//      is the max over the whole row of the chunk, not over a sub-tile's
//      columns.  Each warp first takes it over every column j <= l of its
//      rows (gates only, l / 4 comparisons a lane: cheap), by the very
//      expression the TPU kernel maximises (`:93-96`), so m_comb and every
//      e^{. - m_comb} equal the plain version's bit for bit, given the same
//      b; qbar is rounded after its stabilized row factor.
//
// What bounds it.  The function moves q, k, v and h once, the gates, the
// states per chunk, and in training den and m_comb per row: bound by bytes
// (PERF.md holds its times beside the bound).  It also takes one exp a
// causal pair of a chunk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "chunkwise_v1.cuh"

using namespace v1;

// dtype, cdtype: 0 = float32, 1 = bfloat16 (storage of q, k, v, h; compute
// type of the products).  c0, n0, m0 may be null (zero initial state);
// den and m_comb null in predict.  Outputs: h (B, NH, S, DH) in the storage
// type; den, m_comb (B, NH, S), c_states (B, NH, NC, DH, DH), n_states
// (B, NH, NC, DH), m_states (B, NH, NC), c_last, n_last, m_last float32.
// Returns a CUDA error code; 1000 for a dtype, head size or chunk the
// kernels do not take.
extern "C" int chunkwise_exp_fw(const void* q, const void* k, const void* v, const float* i,
                                const float* f, const float* c0, const float* n0,
                                const float* m0, void* h, float* den, float* m_comb,
                                float* c_states, float* n_states, float* m_states, float* c_last,
                                float* n_last, float* m_last, int B, int NH, int S, int DH, int L,
                                int dtype, int cdtype, float qk_scale, float eps, void* stream) {
  if (!chunk_ok(S, L)) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dh) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dh)::value;
    return launch_fw<T, CT, D, true>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), i, f, c0,
        n0, static_cast<T*>(h), den, c_states, n_states, c_last, n_last, B * NH, S, L, qk_scale,
        eps, MState{m0, m_states, m_last, nullptr, nullptr, m_comb}, st);
  });
}
