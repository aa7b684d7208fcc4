// Chunkwise sigmoid-input-gate mLSTM backward for Hopper, sm_90a.
//
// Replaces the TPU kernel `_bw_fused_kernel` (xlstm_yolo_tpu/ops/pallas/
// chunkwise_v2.py:446, launched by `_bw` :839) and its transposed-layout
// twin `_bw_fused_kernel_t` (:597), which compute the same function.  The
// denominator is a constant: den = max(|n . q~|, 1) per row, saved by the
// train forward (chunkwise_fw.cu, SAVE), as in the Pallas VJP.  Per chunk,
// walking the chunks in reverse with dC (the gradient of the state after
// the chunk) in shared memory, q~ = q * qk_scale:
//
//   dhn  = dh / (den + eps),  D[l, j] = e^{b_l - b_j + logsig(i_j)} (j <= l)
//   P    = (dhn v^T) * D,     SD = (q~ k^T) * D
//   dq   = P k * qk_scale + e^{b_l} qk_scale (dhn C_prev^T)
//   dk   = P^T q~ + e^{a_j} (v dC^T)
//   dv   = SD^T dhn + e^{a_j} (k dC)
//   dC  <- e^{g} dC + (q~ e^{b})^T dhn
//
// and dC0, the gradient of the state before the first chunk, at the end.
// b, a, g are the gate rows of the forward (within-chunk cumsum of
// logsig(f), recomputed here from i and f).  The exponent of D is masked
// before exp: above the diagonal b_l - b_j > 0 overflows once the forget
// gates close.  Ragged S is masked in the kernel: rows past S are zero and
// their gates inert.  The gate gradients (q.dq, k.dk sums) are left to
// PyTorch beside the kernel, as the JAX package leaves them to XLA.
//
// Design.  One block of 256 threads per (batch, head) walks the chunks of
// L = 64 rows from the last to the first.  q~, k, v and dhn of the chunk,
// the causal P and SD tiles, C_prev and dC live in shared memory (float32,
// row stride DH + 1 against bank conflicts): 75 KB at DH = 32, 131 KB at
// 64 (dynamic shared memory).  Per chunk: load; P and SD as 4x4 register
// tiles; dq, dk, dv for one row and DH / 4 columns per thread, one output
// at a time (two DH / 4 sums live per thread); then the dC update.
// All arithmetic is float32 FMA; bf16 inputs are widened on load, dq, dk
// and dv rounded once on store.
//
// DH = 128 (vil-det-384).  The tiles (132 KB), P and SD (33 KB) and dC
// (66 KB) fill a block's 227 KB, and C_prev (another 66 KB) does not fit.
// Its one reader is the dq term dhn C_prev^T, so there it is read from
// the saved per-chunk states in device memory (through L1 and L2; the 64
// rows of the chunk read the same 64 KB), in the order the staged copy
// is read: the numbers are those of the staged layout.  The chunk stays
// L = 64 rows, as the forward saves one state per 64 rows.
//
// What bounds it.  At B = 8, S = 6400, bf16 the function moves ~320 MB (q,
// k, v, dh read, dq, dk, dv written, the saved states read), ~0.1 ms at
// 3.35 TB/s, and does ~20 GFLOP: bound by bytes.  Like the forward, this
// first version has only B * NH = 96 blocks that walk their chunks in
// series, so it is bound by the latency of that chain, far from the bytes
// bound; a chunk-parallel design is left to a later change (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int L = 64;    // chunk rows
constexpr int NT = 256;  // threads per block

using port::from_f32;
using port::to_f32;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// C_prev is staged in shared memory where it fits (DH <= 64).
template <int DH>
__host__ __device__ constexpr bool stage_c() { return DH <= 64; }

template <int DH>
constexpr size_t smem_floats() {
  return 4 * L * (DH + 1)                    // q~, k, v, dhn
         + 2 * L * (L + 1)                   // P, SD
         + (stage_c<DH>() ? 2 : 1) * DH * (DH + 1)  // (C_prev,) dC
         + 3 * L;                            // b, e^b, logsig(i)
}

static_assert(4 * smem_floats<128>() <= 232448, "a block's shared memory on Hopper");

template <typename T, int DH>
__global__ void __launch_bounds__(NT) chunkwise_bw_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg,
    const float* __restrict__ c_states, const float* __restrict__ den,
    const T* __restrict__ dh, const float* __restrict__ dc_last, T* __restrict__ dq,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dc0, int S, int NH,
    float qk_scale, float eps) {
  constexpr bool STAGE_C = stage_c<DH>();
  constexpr int DP = DH + 1;  // padded row stride of the (L, DH) tiles
  constexpr int LP = L + 1;   // padded row stride of the (L, L) tiles
  constexpr int CPT = DH / 4; // output columns per thread (4 threads per row)
  constexpr int TPR = NT / DH;  // threads per dC row
  constexpr int VPT = DH / TPR; // dC columns per thread

  extern __shared__ float smem[];
  float* sq = smem;              // (L, DP) q~
  float* sk = sq + L * DP;       // (L, DP) k
  float* sv = sk + L * DP;       // (L, DP) v
  float* sdh = sv + L * DP;      // (L, DP) dhn
  float* sP = sdh + L * DP;      // (L, LP) P
  float* sSD = sP + L * LP;      // (L, LP) SD
  float* sdC = sSD + L * LP;     // (DH, DP) dC
  float* sC = sdC + DH * DP;     // (DH, DP) C_prev, if STAGE_C
  float* sb = sC + (STAGE_C ? DH * DP : 0);  // (L) b
  float* seb = sb + L;           // (L) e^b
  float* sli = seb + L;          // (L) logsig(i)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / NH;
  const int hd = bh - b * NH;
  const int H = NH * DH;
  const int NC = (S + L - 1) / L;
  const size_t row0 = (size_t)b * S * H + (size_t)hd * DH;
  const size_t gate0 = (size_t)b * S * NH + hd;

  for (int e = tid; e < DH * DH; e += NT)
    sdC[(e / DH) * DP + e % DH] = dc_last ? dc_last[(size_t)bh * DH * DH + e] : 0.f;

  for (int c = NC - 1; c >= 0; --c) {
    const int t0 = c * L;
    const size_t chunk_bh = ((size_t)b * NC + c) * NH + hd;

    // 1. tiles (rows past S zero), C_prev, gate rows
    for (int e = tid; e < L * DH; e += NT) {
      const int r = e / DH, col = e - r * DH;
      float qv = 0.f, kv = 0.f, vv = 0.f, dv_ = 0.f;
      if (t0 + r < S) {
        const size_t off = row0 + (size_t)(t0 + r) * H + col;
        qv = to_f32(q[off]);
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
        dv_ = to_f32(dh[off]) / (den[chunk_bh * L + r] + eps);
      }
      sq[r * DP + col] = qv * qk_scale;
      sk[r * DP + col] = kv;
      sv[r * DP + col] = vv;
      sdh[r * DP + col] = dv_;
    }
    const float* cprev = c_states + chunk_bh * DH * DH;
    if constexpr (STAGE_C)
      for (int e = tid; e < DH * DH; e += NT) sC[(e / DH) * DP + e % DH] = cprev[e];
    if (tid < 32) {  // one warp, two rows per lane: inclusive scan of logsig(f)
      const int r0 = 2 * tid, r1 = r0 + 1;
      float lf0 = 0.f, lf1 = 0.f, li0 = -CUDART_INF_F, li1 = -CUDART_INF_F;
      if (t0 + r0 < S) {
        lf0 = log_sigmoid(fg[gate0 + (size_t)(t0 + r0) * NH]);
        li0 = log_sigmoid(ig[gate0 + (size_t)(t0 + r0) * NH]);
      }
      if (t0 + r1 < S) {
        lf1 = log_sigmoid(fg[gate0 + (size_t)(t0 + r1) * NH]);
        li1 = log_sigmoid(ig[gate0 + (size_t)(t0 + r1) * NH]);
      }
      float incl = lf0 + lf1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += y;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      const float b0 = excl + lf0;
      const float b1 = b0 + lf1;
      sb[r0] = b0;  // g, the chunk's total, is sb[L - 1]
      sb[r1] = b1;
      seb[r0] = expf(b0);
      seb[r1] = expf(b1);
      sli[r0] = li0;
      sli[r1] = li1;
    }
    __syncthreads();

    // 2. P = (dhn v^T) * D and SD = (q~ k^T) * D, one 4x4 tile per thread
    {
      const int ti = tid / 16, tj = tid % 16;
      float aP[4][4], aS[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) aP[r][s] = aS[r][s] = 0.f;
      if (tj <= ti) {
#pragma unroll 4
        for (int d = 0; d < DH; ++d) {
          float qa[4], da[4], kb[4], vb[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            qa[r] = sq[(ti * 4 + r) * DP + d];
            da[r] = sdh[(ti * 4 + r) * DP + d];
            kb[r] = sk[(tj * 4 + r) * DP + d];
            vb[r] = sv[(tj * 4 + r) * DP + d];
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              aS[r][s] = fmaf(qa[r], kb[s], aS[r][s]);
              aP[r][s] = fmaf(da[r], vb[s], aP[r][s]);
            }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = ti * 4 + r;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = tj * 4 + s;
          // the exponent is masked before exp: b_l - b_j > 0 above the diagonal
          const float dm = (j <= l) ? expf(sb[l] - sb[j] + sli[j]) : 0.f;
          sP[l * LP + j] = aP[r][s] * dm;
          sSD[l * LP + j] = aS[r][s] * dm;
        }
      }
    }
    __syncthreads();

    // 3. dq, dk, dv for row `row`, columns [cc, cc + CPT), one at a time:
    //    the intra-chunk sum, then the inter-chunk one
    {
      const int row = tid / 4;
      const int cc = (tid % 4) * CPT;
      const bool store = t0 + row < S;
      const size_t off = row0 + (size_t)(t0 + row) * H + cc;
      const float g = sb[L - 1];
      const float eb = seb[row] * qk_scale, ea = expf((g - sb[row]) + sli[row]);
      float a[CPT], in[CPT];
      // dq = P k * qk_scale + e^b qk_scale (dhn C_prev^T)
#pragma unroll
      for (int x = 0; x < CPT; ++x) a[x] = in[x] = 0.f;
      for (int j = 0; j <= row; ++j) {
        const float p = sP[row * LP + j];
#pragma unroll
        for (int x = 0; x < CPT; ++x) a[x] = fmaf(p, sk[j * DP + cc + x], a[x]);
      }
#pragma unroll 4
      for (int u = 0; u < DH; ++u) {
        const float dhu = sdh[row * DP + u];
#pragma unroll
        for (int x = 0; x < CPT; ++x) {
          const float cv = STAGE_C ? sC[(cc + x) * DP + u] : __ldg(cprev + (cc + x) * DH + u);
          in[x] = fmaf(dhu, cv, in[x]);
        }
      }
      if (store)
#pragma unroll
        for (int x = 0; x < CPT; ++x) from_f32(fmaf(a[x], qk_scale, eb * in[x]), dq + off + x);
      // dk = P^T q~ + e^a (v dC^T)
#pragma unroll
      for (int x = 0; x < CPT; ++x) a[x] = in[x] = 0.f;
      for (int l = row; l < L; ++l) {
        const float p = sP[l * LP + row];
#pragma unroll
        for (int x = 0; x < CPT; ++x) a[x] = fmaf(p, sq[l * DP + cc + x], a[x]);
      }
#pragma unroll 4
      for (int u = 0; u < DH; ++u) {
        const float vu = sv[row * DP + u];
#pragma unroll
        for (int x = 0; x < CPT; ++x) in[x] = fmaf(vu, sdC[(cc + x) * DP + u], in[x]);
      }
      if (store)
#pragma unroll
        for (int x = 0; x < CPT; ++x) from_f32(fmaf(ea, in[x], a[x]), dk + off + x);
      // dv = SD^T dhn + e^a (k dC)
#pragma unroll
      for (int x = 0; x < CPT; ++x) a[x] = in[x] = 0.f;
      for (int l = row; l < L; ++l) {
        const float sd = sSD[l * LP + row];
#pragma unroll
        for (int x = 0; x < CPT; ++x) a[x] = fmaf(sd, sdh[l * DP + cc + x], a[x]);
      }
#pragma unroll 4
      for (int u = 0; u < DH; ++u) {
        const float ku = sk[row * DP + u];
#pragma unroll
        for (int x = 0; x < CPT; ++x) in[x] = fmaf(ku, sdC[u * DP + cc + x], in[x]);
      }
      if (store)
#pragma unroll
        for (int x = 0; x < CPT; ++x) from_f32(fmaf(ea, in[x], a[x]), dv + off + x);
    }
    __syncthreads();

    // 4. dC <- e^g dC + (q~ e^b)^T dhn: row dk_, columns [dv0, dv0 + VPT)
    {
      const int dk_ = tid / TPR;
      const int dv0 = (tid % TPR) * VPT;
      float acc[VPT];
#pragma unroll
      for (int x = 0; x < VPT; ++x) acc[x] = 0.f;
#pragma unroll 4
      for (int l = 0; l < L; ++l) {
        const float qb = sq[l * DP + dk_] * seb[l];
#pragma unroll
        for (int x = 0; x < VPT; ++x) acc[x] = fmaf(qb, sdh[l * DP + dv0 + x], acc[x]);
      }
      const float eg = expf(sb[L - 1]);
#pragma unroll
      for (int x = 0; x < VPT; ++x)
        sdC[dk_ * DP + dv0 + x] = fmaf(eg, sdC[dk_ * DP + dv0 + x], acc[x]);
    }
    __syncthreads();
  }

  for (int e = tid; e < DH * DH; e += NT)
    dc0[(size_t)bh * DH * DH + e] = sdC[(e / DH) * DP + e % DH];
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const float* i, const float* f,
           const float* cs, const float* den, const void* dh, const float* dcl, void* dq,
           void* dk, void* dv, float* dc0, int B, int S, int NH, float qk_scale, float eps,
           cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats<DH>();
  cudaError_t err = port::allow_smem(chunkwise_bw_kernel<T, DH>, smem);
  if (err != cudaSuccess) return (int)err;
  chunkwise_bw_kernel<T, DH><<<B * NH, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), i, f, cs,
      den, static_cast<const T*>(dh), dcl, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), dc0, S, NH, qk_scale, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  c_states (B, NC, NH, DH, DH) and den
// (B, NC, NH, L) come from chunkwise_fw_train; dc_last (B, NH, DH, DH) may
// be null.  Outputs dq, dk, dv (B, S, NH * DH) in the dtype and dc0
// (B, NH, DH, DH) float32.  Returns a CUDA error code; 1000 for an
// unsupported dtype or head size.
extern "C" int chunkwise_bw(const void* q, const void* k, const void* v, const float* i,
                            const float* f, const float* c_states, const float* den,
                            const void* dh, const float* dc_last, void* dq, void* dk, void* dv,
                            float* dc0, int B, int S, int NH, int DH, int dtype, float qk_scale,
                            float eps, void* stream) {
  return port::dispatch(dtype, dtype, DH, [&](auto t, auto, auto dhd) -> int {
    using T = decltype(t);
    constexpr int D = decltype(dhd)::value;
    return launch<T, D>(q, k, v, i, f, c_states, den, dh, dc_last, dq, dk, dv, dc0, B, S, NH,
                        qk_scale, eps, static_cast<cudaStream_t>(stream));
  });
}
