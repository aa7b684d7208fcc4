// Chunkwise exponential-input-gate mLSTM backward with the max stabilizer,
// for Hopper, sm_90a: two kernels, as on the TPU.
//
// Replaces the TPU kernels `_bw_dc_kernel` (xlstm_yolo_tpu/ops/pallas/
// chunkwise_exp.py:284, call :438) and `_bw_dqkv_kernel` (:330, call :473),
// both launched by `_bw` :406.  The stabilizers (m per chunk, m_comb per
// row) and the denominator saved by the forward are constants, as in the
// Pallas VJP.  The wrapper computes, per chunk, m_new (the next chunk's
// m_prev, or m_last) and gbar = e^{(g + m_prev) - m_new} (`:423-431`).
// With dhn = dh / (den + eps), D = tril(e^{((b_l - b_j) + i_j) - m_comb_l}),
// Qbar = q e^{(b + m_prev) - m_comb} scale, Kbar = k e^{a - m_new} and R()
// the rounding to the compute type at the TPU kernels' casts (`:318-322,
// :354-402`):
//
//   chunkwise_exp_bw_dc:   dC_{k-1} = gbar_k dC_k + R(Qbar_k)^T R(dhn_k),
//                          walking the chunks in reverse from dC_last (or
//                          zeros); dc_states[k] = dC_k, dc0 = dC_{-1} (in
//                          the scaling of m_initial);
//   chunkwise_exp_bw_dqkv: per chunk, from c_states[k] = C_{k-1} and dC_k,
//                          P  = (R(dhn) R(v)^T) * D,  SD = (R(q) R(k)^T scale) * D
//                          dq = R(P) R(k) scale + (R(dhn) R(C_{k-1})^T) e^{(b + m_prev) - m_comb} scale
//                          dk = R(P)^T R(q) scale + (R(v) R(dC_k)^T) e^{a - m_new}
//                          dv = R(SD)^T R(dhn) + R(Kbar) R(dC_k)
//
// summed in float32 and written in the input dtype, as the Pallas kernel
// writes them; the wrapper computes the gate gradients from them.
//
// Design.  The shared kernels of chunkwise_v1.cuh with the exp gate: the
// dC scan is state_scan_kernel, one block per (batch, head); dq/dk/dv is
// dqkv_kernel, every (batch * head, chunk, 64-row sub-tile, part) a block,
// which reads the chunk's m_comb rows, so a sub-tile's D uses the whole
// row's stabilizer.  Products are float32 FMA on the CUDA cores with
// rounded operands.
//
// What bounds it.  The pair moves q, k, v, dh, dq, dk, dv once, the gates,
// den and m_comb per row, and the states and m per chunk: bound by bytes
// (PERF.md).  The (L x L) tiles in float32 FMA cost more; PERF.md holds
// the times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "chunkwise_v1.cuh"

using namespace v1;

// dtype, cdtype: 0 = float32, 1 = bfloat16 (storage of q and dh; compute
// type of the products).  den, m_comb (B, NH, S) from chunkwise_exp_fw;
// mrow (B, NH, NC, 2) holds [m_prev, gbar] per chunk; dc_last
// (B, NH, DH, DH) may be null.  Outputs dc_states (B, NH, NC, DH, DH) and
// dc0 (B, NH, DH, DH) float32.  Returns a CUDA error code; 1000 for a
// dtype, head size or chunk the kernels do not take.
extern "C" int chunkwise_exp_bw_dc(const void* q, const float* f, const void* dh,
                                   const float* den, const float* m_comb, const float* mrow,
                                   const float* dc_last, float* dc_states, float* dc0, int B,
                                   int NH, int S, int DH, int L, int dtype, int cdtype,
                                   float qk_scale, float eps, void* stream) {
  if (!chunk_ok(S, L)) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dhd) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dhd)::value;
    return launch_with_smem(state_scan_kernel<T, CT, D, true, true>, dim3(B * NH),
                            sizeof(float) * scan_smem_floats<D>(), st, static_cast<const T*>(q),
                            static_cast<const T*>(dh), nullptr, f, den, dc_last, nullptr,
                            dc_states, nullptr, dc0, nullptr, S, L, qk_scale, eps,
                            MState{nullptr, nullptr, nullptr, mrow, m_comb, nullptr});
  });
}

// The same types; c_states, den, m_comb from chunkwise_exp_fw, mrow
// (B, NH, NC, 2) [m_prev, m_new] per chunk, dc_states from
// chunkwise_exp_bw_dc.  Outputs dq, dk, dv (B, NH, S, DH) in the storage
// type.
extern "C" int chunkwise_exp_bw_dqkv(const void* q, const void* k, const void* v,
                                     const float* i, const float* f, const float* c_states,
                                     const float* den, const float* m_comb, const float* mrow,
                                     const void* dh, const float* dc_states, void* dq, void* dk,
                                     void* dv, int B, int NH, int S, int DH, int L, int dtype,
                                     int cdtype, float qk_scale, float eps, void* stream) {
  if (!chunk_ok(S, L)) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dhd) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dhd)::value;
    const dim3 grid((S / L) * (L / tile_rows(L, dqkv_rows<D>())), B * NH, 2);
    return launch_with_smem(dqkv_kernel<T, CT, D, true, T>, grid,
                            sizeof(float) * dqkv_smem_floats<D>(), st, static_cast<const T*>(q),
                            static_cast<const T*>(k), static_cast<const T*>(v), i, f, c_states,
                            den, static_cast<const T*>(dh), dc_states, static_cast<T*>(dq),
                            static_cast<T*>(dk), static_cast<T*>(dv), S, L, qk_scale, eps,
                            MState{nullptr, nullptr, nullptr, mrow, m_comb, nullptr});
  });
}
