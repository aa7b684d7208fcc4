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
//   2. h_kernel: every (batch * head, chunk, 64-row sub-tile) is its own
//      block, 96 * S / 64 blocks at the flagship's batch 8.  It reads the
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

namespace {

using namespace v1;

template <int DH>
constexpr size_t h_smem_floats() {
  return 2 * LMAX                 // b, logsig(i)
         + 4 * TR * (DH + 1)      // R(q), qbar, R(k), R(v)
         + DH * (DH + 1) + DH     // R(C_prev), n_prev
         + TR * (TR + 1);         // sd tile
}

template <typename T, typename CT, int DH>
__global__ void __launch_bounds__(NT) h_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg,
    const float* __restrict__ c_states, const float* __restrict__ n_states, T* __restrict__ h,
    float* __restrict__ den_out, int S, int L, float qk_scale, float eps) {
  constexpr int DP = DH + 1;
  constexpr int CPT = DH / 4;  // output columns per thread, 4 threads per row
  extern __shared__ float smem[];
  float* sb = smem;
  float* sli = sb + LMAX;
  float* sq = sli + LMAX;     // (TR, DP) R(q)
  float* sqb = sq + TR * DP;  // (TR, DP) qbar, unrounded
  float* sk = sqb + TR * DP;  // (TR, DP) R(k) of the key sub-tile
  float* sv = sk + TR * DP;   // (TR, DP) R(v) of the key sub-tile
  float* sC = sv + TR * DP;   // (DH, DP) R(C_prev)
  float* sn = sC + DH * DP;   // (DH) n_prev
  float* ssd = sn + DH;       // (TR, TR + 1) sd

  const int tid = threadIdx.x;
  const int T_ = tile_rows(L);
  const int tiles = L / T_;
  const int c = blockIdx.x / tiles, st = blockIdx.x - c * tiles;
  const int bh = blockIdx.y;
  const int NC = S / L;
  const size_t t0 = (size_t)bh * S + (size_t)c * L;  // first row of the chunk
  const size_t slot = (size_t)bh * NC + c;

  chunk_gates(ig + t0, fg + t0, L, sb, sli);
  for (int e = tid; e < DH * DH; e += NT)
    sC[(e / DH) * DP + e % DH] = rt<CT>(c_states[slot * DH * DH + e]);
  if (tid < DH) sn[tid] = n_states[slot * DH + tid];
  __syncthreads();
  const int q0 = st * T_;  // chunk row of the first query row
  for (int e = tid; e < T_ * DH; e += NT) {
    const int r = e / DH, d = e - r * DH;
    const float x = to_f32(q[(t0 + q0 + r) * DH + d]);
    sq[r * DP + d] = rt<CT>(x);
    sqb[r * DP + d] = (x * expf(sb[q0 + r])) * qk_scale;
  }
  __syncthreads();

  const int row = tid / 4, cc = (tid % 4) * CPT;
  const bool has_row = row < T_;
  float hi[CPT], ha[CPT];  // inter- and intra-chunk parts of the numerator
#pragma unroll
  for (int x = 0; x < CPT; ++x) hi[x] = ha[x] = 0.f;
  float n_inter = 0.f, n_intra = 0.f;
  if (has_row) {
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float qb = sqb[row * DP + d];
      n_inter = fmaf(qb, sn[d], n_inter);
      const float qr = rt<CT>(qb);
#pragma unroll
      for (int x = 0; x < CPT; ++x) hi[x] = fmaf(qr, sC[d * DP + cc + x], hi[x]);
    }
  }

  const int TT = T_ / 4;  // 4 x 4 register tiles per side of a (T_, T_) tile
  for (int kt = 0; kt <= st; ++kt) {
    const int k0 = kt * T_;
    for (int e = tid; e < T_ * DH; e += NT) {
      const int r = e / DH, d = e - r * DH;
      const size_t off = (t0 + k0 + r) * DH + d;
      sk[r * DP + d] = rt<CT>(to_f32(k[off]));
      sv[r * DP + d] = rt<CT>(to_f32(v[off]));
    }
    __syncthreads();
    if (tid < TT * TT) {  // sd = R(q) R(k)^T scale * D, masked above the diagonal
      const int ti = tid / TT, tj = tid % TT;
      float acc[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float qa[4], kb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qa[r] = sq[(ti * 4 + r) * DP + d];
          kb[r] = sk[(tj * 4 + r) * DP + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(qa[r], kb[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = q0 + ti * 4 + r;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = k0 + tj * 4 + s;
          // the exponent is masked before exp: b_l - b_j > 0 above the diagonal
          ssd[(ti * 4 + r) * (TR + 1) + tj * 4 + s] =
              j <= l ? (acc[r][s] * qk_scale) * expf(sb[l] - sb[j] + sli[j]) : 0.f;
        }
      }
    }
    __syncthreads();
    if (has_row) {
      for (int j = 0; j < T_; ++j) {
        const float s = ssd[row * (TR + 1) + j];
        n_intra += s;
        const float sr = rt<CT>(s);
#pragma unroll
        for (int x = 0; x < CPT; ++x) ha[x] = fmaf(sr, sv[j * DP + cc + x], ha[x]);
      }
    }
    __syncthreads();
  }

  if (has_row) {
    const float den = fmaxf(fabsf(n_inter + n_intra), 1.f);
    const size_t r = t0 + q0 + row;
    if (cc == 0) den_out[r] = den;
    const float inv = den + eps;
#pragma unroll
    for (int x = 0; x < CPT; ++x) from_f32((hi[x] + ha[x]) / inv, h + r * DH + cc + x);
  }
}

}  // namespace

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
    state_scan_kernel<T, CT, D, false><<<B * NH, NT, 0, st>>>(
        kt, vt, i, f, nullptr, c0, n0, c_states, n_states, c_last, n_last, S, L, qk_scale, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = sizeof(float) * h_smem_floats<D>();
    err = cudaFuncSetAttribute(h_kernel<T, CT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S / L) * (L / tile_rows(L)), B * NH);
    h_kernel<T, CT, D><<<grid, NT, smem, st>>>(qt, kt, vt, i, f, c_states, n_states,
                                               static_cast<T*>(h), den, S, L, qk_scale, eps);
    return (int)cudaGetLastError();
  });
}
