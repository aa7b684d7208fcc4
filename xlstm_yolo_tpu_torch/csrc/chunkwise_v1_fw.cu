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
// blocks run in no order, so the forward is two launches:
//   1. state_scan_kernel (chunkwise_v1.cuh): one block per (batch, head)
//      walks the chunks and writes C, n before each and the last states;
//      a chunk is a (L x DH)^T (L x DH) product, read in tiles of 64 rows;
//   2. h_kernel (chunkwise_v1.cuh): every (batch * head, chunk, 64-row
//      sub-tile) is its own block, 96 * S / 64 blocks at the flagship's
//      batch 8.  It reads the
//      chunk's C and n, builds the gate rows of the chunk, and walks the
//      key sub-tiles at or before its own: a chunk of 512 rows makes
//      (512 x 512) score and decay tiles (1 MB in float32), which do not fit
//      in 227 KB of shared memory, so it takes them 64 x 64 at a time.
// Products are float32 FMA on the CUDA cores with the operands rounded
// as above (no tensor cores yet).
//
// What bounds it.  The function moves q, k, v and h once, the gates, and
// the states per chunk (B * NH * NC * (DH + 1) * DH floats): bound by bytes
// at every L (PERF.md).  This version's (L x L) intra-chunk products grow
// with L, and on float32 FMA at L = 512 they cost more than the bytes; it
// is a first, right version, and PERF.md holds its times.

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
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const int err = launch_with_smem(
        state_scan_kernel<T, CT, D, false, false>, dim3(B * NH),
        sizeof(float) * scan_smem_floats<D>(), st, kt, vt, i, f, nullptr, c0, n0, c_states,
        n_states, c_last, n_last, S, L, qk_scale, eps, MState{});
    if (err != 0) return err;
    return launch_with_smem(h_kernel<T, CT, D, false>, dim3((S / L) * (L / tile_rows(L)), B * NH),
                            sizeof(float) * h_smem_floats<D>(), st, qt, kt, vt, i, f, c_states,
                            n_states, static_cast<T*>(h), den, S, L, qk_scale, eps, MState{});
  });
}
