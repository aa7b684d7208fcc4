// Chunkwise sigmoid-input-gate mLSTM backward for Hopper, sm_90a.
//
// Replaces the TPU kernel `_bw_fused_kernel` (xlstm_yolo_tpu/ops/pallas/
// chunkwise_v2.py:446, launched by `_bw` :839) and its transposed-layout
// twin `_bw_fused_kernel_t` (:597), which compute the same function.  The
// denominator is a constant: den = max(|n . q~|, 1) per row, saved by the
// train forward (chunkwise_fw.cu, SAVE), as in the Pallas VJP.  Per chunk
// of L = 64 rows, walking the chunks in reverse with dC (the gradient of
// the state after the chunk), R(x) the operand x of a product rounded to
// the compute type (JAX's .astype(dtype); the identity in float32):
//
//   dhn  = dh / (den + eps),  D[l, j] = e^{b_l - b_j + logsig(i_j)} (j <= l)
//   P    = (R(dhn) R(v)^T) * D,     SD = (R(q) R(k)^T) * scale * D
//   dq   = R(P) R(k) scale + e^{b_l} scale (R(dhn) R(C_prev)^T)
//   dk   = R(P)^T R(q) scale + e^{a_j} (R(v) R(dC)^T)
//   dv   = R(SD)^T R(dhn) + R(k e^{a_j}) R(dC)
//   dC  <- e^{g} dC + R(q e^{b} scale)^T R(dhn)
//
// and dC0, the gradient of the state before the first chunk, at the end.
// b, a, g are the gate rows of the forward (within-chunk cumsum of
// logsig(f), recomputed here from i and f).  The exponent of D is masked
// before exp: above the diagonal b_l - b_j > 0 overflows once the forget
// gates close.  Ragged S is masked in the kernel: rows past S are zero and
// their gates inert.  The gate gradients (q.dq, k.dk sums) are left to
// PyTorch beside the kernel, as the JAX package leaves them to XLA.
//
// What bounds it.  At B = 8, S = 6400, NH = 6, DH = 128, bf16 the function
// reads q, k, v, dh, the gates, den and the state saved before each chunk
// (315 MB of float32) and writes dq, dk, dv and dC0: ~0.55 GB, 0.16 ms at
// 3.35 TB/s, against ~60 GFLOP (0.06 ms on the tensor cores): bound by
// bytes.  The design below also writes and reads a dC per chunk (157 MB
// each way in bf16).
//
// Design: two passes, the products in the mma fragment layout
// (tc::prod16, csrc/mma.cuh): on the tensor cores (mma.sync m16n8k16, bf16
// operands rounded where the Pallas kernel rounds them, float32 sums) for
// bf16, float32 FMA for float32.  The train forward saves the state before
// every chunk, so the only serial dependency is dC:
//  1. bw_dc_kernel, the dC scan: one block of 4 warps per (batch, head,
//     16 rows of dC) walks the chunks backwards, dC in float32 registers in
//     the accumulator layout.  Per chunk it stores R(dC) (the gradient of
//     the state after the chunk) into a scratch buffer (B, NC, NH, DH, DH)
//     in the storage type (every reader rounds dC to it first), then dC <-
//     e^g dC + R(qbar)^T R(dhn), the next chunk's q, dh, den and f loading
//     with cp.async meanwhile.  dC0 in float32 at the end.
//  2. bw_dqkv_kernel: one block of 8 warps per (batch, head, chunk), all
//     independent (4,800 blocks at B 8, S 6400, NH 6, where the first
//     port's one block per (batch, head) walking the chunks gave 48): q, k,
//     v, dh and the scratch dC by cp.async, C_prev from the saved float32
//     states rounded to the storage type, in shared memory (156 KB at DH
//     128 in bf16; in float32 at DH 128 C_prev and dC are read through
//     L1/L2 instead, 170 KB); P and SD as 64 x 64 products, kept rounded;
//     then dq, dk and dv as 64 x DH products, each warp 16 rows and half of
//     DH, the causal half of the P and SD sums skipped.
// On the card the first port's serial kernel took 2.46 / 33.0 ms a call in
// bf16 at DH 32 / 128 (B 8, S 6400) against these passes' 0.485 / 1.57
// (PERF.md, PR 9).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using port::from_f32;
using port::NT;
using port::to_f32;
using tc::bf16;
using tc::prod16;
using tc::st2;

constexpr int L = 64;     // chunk rows
constexpr int TRW = 16;   // rows of dC a block of the dC scan owns
constexpr int NT1 = 128;  // threads of a dC-scan block

// Shared-memory row padding: bf16 rows 16 mod 128 bytes (ldmatrix bank
// groups), float32 rows 4 mod 32 floats (the FMA products' reads).
template <typename T>
__host__ __device__ constexpr int pad() { return sizeof(T) == 2 ? 8 : 4; }

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

template <typename T, int DH>
struct DcSmem {
  static constexpr int LDQ = TRW + pad<T>(), LDH = DH + pad<T>();
  static constexpr size_t bytes =
      sizeof(T) * (2 * L * TRW + 2 * L * DH + L * LDQ + L * LDH) + 4 * (6 * L);
};

// One block per (batch * head, 16 rows i0.. of dC); warp w holds columns
// 8 w NTW.. of its rows (DH 16: warps 0 and 1).
template <typename T, int DH>
__global__ void __launch_bounds__(NT1) bw_dc_kernel(
    const T* __restrict__ q, const float* __restrict__ fg, const float* __restrict__ den,
    const T* __restrict__ dh, const float* __restrict__ dc_last, T* __restrict__ dcs,
    float* __restrict__ dc0, int S, int NH, float qk_scale, float eps) {
  constexpr int LDQ = DcSmem<T, DH>::LDQ, LDH = DcSmem<T, DH>::LDH;
  constexpr int NTW = DH >= 32 ? DH / 32 : 1;  // n-tiles of 8 columns a warp
  constexpr int E = 16 / sizeof(T);            // elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rq = reinterpret_cast<T*>(smem_raw);  // 2 x (L, TRW) raw q columns i0..
  T* rdh = rq + 2 * L * TRW;               // 2 x (L, DH) raw dh
  T* sqb = rdh + 2 * L * DH;               // (L, LDQ) R(q e^b scale)
  T* sdhn = sqb + L * LDQ;                 // (L, LDH) R(dhn)
  float* rden = reinterpret_cast<float*>(sdhn + L * LDH);  // 2 x (L)
  float* rf = rden + 2 * L;                // 2 x (L)
  float* sb = rf + 2 * L;                  // (L)
  float* seb = sb + L;                     // (L)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / NH, hd = bh - b * NH;
  const int i0 = blockIdx.y * TRW;
  const int H = NH * DH, NC = (S + L - 1) / L;
  const size_t row0 = (size_t)b * S * H + (size_t)hd * DH;
  const size_t gate0 = (size_t)b * S * NH + hd;
  const bool active = warp * NTW * 8 < DH;
  const int n0 = warp * NTW * 8;

  auto prefetch = [&](int c, int buf) {
    const int t0 = c * L;
    const size_t chunk_bh = ((size_t)b * NC + c) * NH + hd;
    for (int e = tid; e < L * (TRW / E); e += NT1) {
      const int r = e / (TRW / E), cc = e - r * (TRW / E);
      const bool ok = t0 + r < S;
      tc::cp_async16(rq + buf * L * TRW + r * TRW + E * cc,
                     q + (ok ? row0 + (size_t)(t0 + r) * H + i0 + E * cc : 0), ok);
    }
    for (int e = tid; e < L * (DH / E); e += NT1) {
      const int r = e / (DH / E), cc = e - r * (DH / E);
      const bool ok = t0 + r < S;
      tc::cp_async16(rdh + buf * L * DH + r * DH + E * cc,
                     dh + (ok ? row0 + (size_t)(t0 + r) * H + E * cc : 0), ok);
    }
    for (int e = tid; e < L / 4; e += NT1)
      tc::cp_async16(rden + buf * L + 4 * e, den + chunk_bh * L + 4 * e, true);
    for (int e = tid; e < L; e += NT1) {
      const bool ok = t0 + e < S;
      tc::cp_async4(rf + buf * L + e, fg + (ok ? gate0 + (size_t)(t0 + e) * NH : 0), ok);
    }
    tc::cp_async_commit();
  };

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = i0 + gq + 8 * (x >> 1), m = n0 + 8 * j + 2 * tq + (x & 1);
      acc[j][x] = (active && dc_last) ? dc_last[((size_t)bh * DH + i) * DH + m] : 0.f;
    }

  prefetch(NC - 1, 0);
  for (int c = NC - 1, it = 0; c >= 0; --c, ++it) {
    const int buf = it & 1;
    if (active) {  // R(dC), the gradient of the state after chunk c
      T* out = dcs + (((size_t)b * NC + c) * NH + hd) * DH * DH;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st2(out + (size_t)(i0 + gq + 8 * h) * DH + n0 + 8 * j + 2 * tq, acc[j][2 * h],
              acc[j][2 * h + 1]);
    }
    if (c > 0) {
      prefetch(c - 1, buf ^ 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (warp == 0) chunk_gates(rf + buf * L, nullptr, S - c * L, sb, seb, nullptr, nullptr);
    __syncthreads();
    for (int e = tid; e < L * TRW; e += NT1) {
      const int r = e / TRW, col = e - r * TRW;
      from_f32(to_f32(rq[buf * L * TRW + e]) * seb[r] * qk_scale, sqb + r * LDQ + col);
    }
    for (int e = tid; e < L * DH; e += NT1) {
      const int r = e / DH, col = e - r * DH;
      from_f32(to_f32(rdh[buf * L * DH + e]) / (rden[buf * L + r] + eps), sdhn + r * LDH + col);
    }
    __syncthreads();
    if (active) {  // dC <- e^g dC + R(qbar)^T R(dhn)
      const float eg = seb[L - 1];
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[j][x] *= eg;
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk)
        prod16<NTW, true, true>(acc, sqb, LDQ, 0, sdhn, LDH, n0, 16 * kk);
    }
  }
  if (active)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = i0 + gq + 8 * (x >> 1), m = n0 + 8 * j + 2 * tq + (x & 1);
        dc0[((size_t)bh * DH + i) * DH + m] = acc[j][x];
      }
}

// C_prev and dC of a chunk in shared memory, except in float32 at DH 128,
// where they would take the shared memory past a block's 227 KB and are
// read from device memory (through L1/L2) instead.
template <typename T, int DH>
__host__ __device__ constexpr bool stage_states() { return !(sizeof(T) == 4 && DH == 128); }

template <typename T, int DH>
struct QkvSmem {
  static constexpr int LD = DH + pad<T>(), LDP = L + pad<T>();
  static constexpr int states = stage_states<T, DH>() ? 2 * DH * LD : 0;
  static constexpr size_t bytes = sizeof(T) * (4 * L * LD + 2 * L * LDP + states) + 4 * (7 * L);
};
static_assert(QkvSmem<bf16, 128>::bytes <= 232448, "a block's shared memory on Hopper");
static_assert(QkvSmem<float, 128>::bytes <= 232448, "a block's shared memory on Hopper");
static_assert(QkvSmem<float, 64>::bytes <= 232448, "a block's shared memory on Hopper");

// The rows r0.. (16 a warp) of a warp's accumulators times `scale`, columns
// n0 + 8 j.., into out (row stride ld) where the row is below `valid`.
template <int NJ, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[NJ][4], float scale, T* out,
                                           size_t ld, int r0, int n0, int valid) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + gq + 8 * h;
      if (r < valid)
        st2(out + r * ld + n0 + 8 * j + 2 * tq, acc[j][2 * h] * scale,
            acc[j][2 * h + 1] * scale);
    }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc row r0 + g (+ 8) times f[r0 + g] (f[r0 + g + 8]) times mul.
template <int NJ>
__device__ __forceinline__ void scale_rows(float (&acc)[NJ][4], const float* f, int r0,
                                           float mul) {
  const int gq = (threadIdx.x & 31) >> 2;
  const float f0 = f[r0 + gq] * mul, f1 = f[r0 + gq + 8] * mul;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    acc[j][0] *= f0;
    acc[j][1] *= f0;
    acc[j][2] *= f1;
    acc[j][3] *= f1;
  }
}

// One block of 8 warps per (chunk, batch * head).  Warp w: rows 16 (w % 4)..
// of the chunk; of P and SD the columns 32 (w / 4).., of dq, dk, dv the
// columns (w / 4) DH / 2...
template <typename T, int DH>
__global__ void __launch_bounds__(NT) bw_dqkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg,
    const float* __restrict__ c_states, const float* __restrict__ den,
    const T* __restrict__ dh, const T* __restrict__ dcs, T* __restrict__ dq,
    T* __restrict__ dk, T* __restrict__ dv, int S, int NH, float qk_scale, float eps) {
  using Sm = QkvSmem<T, DH>;
  constexpr int LD = Sm::LD, LDP = Sm::LDP;
  constexpr bool STAGE = stage_states<T, DH>();
  constexpr int LDC = STAGE ? LD : DH;  // row stride of C_prev and dC where they are read
  constexpr int NJ = DH / 16;  // n-tiles of 8 columns a warp (half of DH)
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);  // (L, DH) q
  T* sk = sq + L * LD;                     // (L, DH) k, then R(k e^a)
  T* sv = sk + L * LD;                     // (L, DH) v
  T* sdh = sv + L * LD;                    // (L, DH) dh, then R(dhn)
  T* sP = sdh + L * LD;                    // (L, L) R(P)
  T* sSD = sP + L * LDP;                   // (L, L) R(SD)
  T* sC = sSD + L * LDP;                   // (DH, DH) R(C_prev), if STAGE
  T* sdC = sC + (STAGE ? DH * LD : 0);     // (DH, DH) R(dC after the chunk), if STAGE
  float* sden = reinterpret_cast<float*>(sdC + (STAGE ? DH * LD : 0));
  float* sf = sden + L;
  float* si = sf + L;
  float* sb = si + L;
  float* seb = sb + L;
  float* sli = seb + L;
  float* sea = sli + L;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / NH, hd = bh - b * NH;
  const int H = NH * DH, NC = (S + L - 1) / L;
  const int t0 = c * L, valid = min(L, S - t0);
  const size_t row0 = (size_t)b * S * H + (size_t)hd * DH + (size_t)t0 * H;
  const size_t gate0 = (size_t)b * S * NH + hd + (size_t)t0 * NH;
  const size_t chunk_bh = ((size_t)b * NC + c) * NH + hd;
  const float* cprev = c_states + chunk_bh * DH * DH;
  const T* dca = dcs + chunk_bh * DH * DH;

  constexpr int CR = DH / E;  // 16-byte copies a row
  for (int e = tid; e < 4 * L * CR; e += NT) {
    const int which = e / (L * CR), f = e - which * (L * CR);
    const int r = f / CR, cc = f - r * CR;
    const bool ok = r < valid;
    const T* src = which == 0 ? q : which == 1 ? k : which == 2 ? v : dh;
    tc::cp_async16(sq + which * L * LD + r * LD + E * cc,
                   src + (ok ? row0 + (size_t)r * H + E * cc : 0), ok);
  }
  if constexpr (STAGE)
    for (int e = tid; e < DH * CR; e += NT) {
      const int r = e / CR, cc = e - r * CR;
      tc::cp_async16(sdC + r * LD + E * cc, dca + (size_t)r * DH + E * cc, true);
    }
  for (int e = tid; e < L / 4; e += NT)
    tc::cp_async16(sden + 4 * e, den + chunk_bh * L + 4 * e, true);
  for (int e = tid; e < L; e += NT) {
    const bool ok = e < valid;
    tc::cp_async4(sf + e, fg + (ok ? gate0 + (size_t)e * NH : 0), ok);
    tc::cp_async4(si + e, ig + (ok ? gate0 + (size_t)e * NH : 0), ok);
  }
  tc::cp_async_commit();
  if constexpr (STAGE)
    for (int e = tid; e < DH * DH / 4; e += NT) {
      const float4 x = reinterpret_cast<const float4*>(cprev)[e];
      const int r = (4 * e) / DH, col = 4 * e - r * DH;
      st2(sC + r * LD + col, x.x, x.y);
      st2(sC + r * LD + col + 2, x.z, x.w);
    }
  // where they are read: staged, or (float32 at DH 128) the saved state and scratch
  const T* rC = STAGE ? sC : reinterpret_cast<const T*>(cprev);
  const T* rdC = STAGE ? sdC : dca;
  tc::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) chunk_gates(sf, si, valid, sb, seb, sli, sea);
  for (int e = tid; e < L * DH; e += NT) {  // dh -> R(dhn) in place
    const int r = e / DH, col = e - r * DH;
    from_f32(to_f32(sdh[r * LD + col]) / (sden[r] + eps), sdh + r * LD + col);
  }
  __syncthreads();

  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int rg = warp & 3, ch = warp >> 2, l0 = 16 * rg;
  {  // P = (R(dhn) R(v)^T) * D, SD = (R(q) R(k)^T) * scale * D, rounded
    float aP[4][4], aS[4][4];
    zero(aP);
    zero(aS);
    if (32 * ch <= l0 + 15) {  // else the 16 x 32 block is above the diagonal
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        prod16<4, false, false>(aP, sdh, LD, l0, sv, LD, 32 * ch, 16 * kk);
        prod16<4, false, false>(aS, sq, LD, l0, sk, LD, 32 * ch, 16 * kk);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = l0 + gq + 8 * h, col = 32 * ch + 8 * j + 2 * tq;
        float p[2], sd[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = col + e;
          // the exponent is masked before exp: b_l - b_j > 0 above the diagonal
          const float dm = jj <= l ? expf(sb[l] - sb[jj] + sli[jj]) : 0.f;
          p[e] = aP[j][2 * h + e] * dm;
          sd[e] = aS[j][2 * h + e] * qk_scale * dm;
        }
        st2(sP + l * LDP + col, p[0], p[1]);
        st2(sSD + l * LDP + col, sd[0], sd[1]);
      }
  }
  __syncthreads();

  const int cb = ch * (DH / 2);
  {  // dq = (e^b (R(dhn) R(C_prev)^T) + R(P) R(k)) scale
    float acc[NJ][4];
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      prod16<NJ, false, false>(acc, sdh, LD, l0, rC, LDC, cb, 16 * kk);
    scale_rows(acc, seb, l0, 1.f);
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      if (kk > rg) break;  // P is 0 above the diagonal
      prod16<NJ, false, true>(acc, sP, LDP, l0, sk, LD, cb, 16 * kk);
    }
    store_rows(acc, qk_scale, dq + row0, H, l0, cb, valid);
  }
  {  // dk = (e^a / scale (R(v) R(dC)^T) + R(P)^T R(q)) scale
    float acc[NJ][4];
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      prod16<NJ, false, false>(acc, sv, LD, l0, rdC, LDC, cb, 16 * kk);
    scale_rows(acc, sea, l0, 1.f / qk_scale);
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      if (kk < rg) continue;  // P^T is 0 below the diagonal
      prod16<NJ, true, true>(acc, sP, LDP, l0, sq, LD, cb, 16 * kk);
    }
    store_rows(acc, qk_scale, dk + row0, H, l0, cb, valid);
  }
  __syncthreads();
  for (int e = tid; e < L * DH; e += NT) {  // k -> R(k e^a) in place
    const int r = e / DH, col = e - r * DH;
    from_f32(to_f32(sk[r * LD + col]) * sea[r], sk + r * LD + col);
  }
  __syncthreads();
  {  // dv = R(k e^a) R(dC) + R(SD)^T R(dhn)
    float acc[NJ][4];
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      prod16<NJ, false, true>(acc, sk, LD, l0, rdC, LDC, cb, 16 * kk);
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      if (kk < rg) continue;
      prod16<NJ, true, true>(acc, sSD, LDP, l0, sdh, LD, cb, 16 * kk);
    }
    store_rows(acc, 1.f, dv + row0, H, l0, cb, valid);
  }
}

template <typename T, int DH>
int launch_dc(const void* q, const float* f, const float* den, const void* dh,
              const float* dcl, void* dcs, float* dc0, int B, int S, int NH, float qk_scale,
              float eps, cudaStream_t st) {
  const size_t smem = DcSmem<T, DH>::bytes;
  cudaError_t err = port::allow_smem(bw_dc_kernel<T, DH>, smem);
  if (err != cudaSuccess) return (int)err;
  bw_dc_kernel<T, DH><<<dim3(B * NH, DH / TRW), NT1, smem, st>>>(
      static_cast<const T*>(q), f, den, static_cast<const T*>(dh), dcl, static_cast<T*>(dcs),
      dc0, S, NH, qk_scale, eps);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_dqkv(const void* q, const void* k, const void* v, const float* i, const float* f,
                const float* cs, const float* den, const void* dh, const void* dcs, void* dq,
                void* dk, void* dv, int B, int S, int NH, float qk_scale, float eps,
                cudaStream_t st) {
  const size_t smem = QkvSmem<T, DH>::bytes;
  cudaError_t err = port::allow_smem(bw_dqkv_kernel<T, DH>, smem);
  if (err != cudaSuccess) return (int)err;
  bw_dqkv_kernel<T, DH><<<dim3((S + L - 1) / L, B * NH), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), i, f, cs,
      den, static_cast<const T*>(dh), static_cast<const T*>(dcs), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), S, NH, qk_scale, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1, the dC scan.  dtype: 0 = float32, 1 = bfloat16.  q, dh (B, S, NH *
// DH) in the dtype; f (B, S, NH) and den (B, NC, NH, L) float32; dc_last
// (B, NH, DH, DH) float32 or null.  Outputs dcs (B, NC, NH, DH, DH) in the
// dtype, the gradient of the state after each chunk, and dc0 (B, NH, DH,
// DH) float32.  Returns a CUDA error code; 1000 for an unsupported dtype
// or head size.
extern "C" int chunkwise_bw_dc(const void* q, const float* f, const float* den, const void* dh,
                               const float* dc_last, void* dcs, float* dc0, int B, int S,
                               int NH, int DH, int dtype, float qk_scale, float eps,
                               void* stream) {
  return port::dispatch(dtype, dtype, DH, [&](auto t, auto, auto dhd) -> int {
    return launch_dc<decltype(t), decltype(dhd)::value>(q, f, den, dh, dc_last, dcs, dc0, B, S,
                                                        NH, qk_scale, eps,
                                                        static_cast<cudaStream_t>(stream));
  });
}

// Pass 2, dq, dk, dv of every chunk from the saved states c_states (B, NC,
// NH, DH, DH) float32 and pass 1's dcs; the rest as pass 1.
extern "C" int chunkwise_bw_dqkv(const void* q, const void* k, const void* v, const float* i,
                                 const float* f, const float* c_states, const float* den,
                                 const void* dh, const void* dcs, void* dq, void* dk, void* dv,
                                 int B, int S, int NH, int DH, int dtype, float qk_scale,
                                 float eps, void* stream) {
  return port::dispatch(dtype, dtype, DH, [&](auto t, auto, auto dhd) -> int {
    return launch_dqkv<decltype(t), decltype(dhd)::value>(
        q, k, v, i, f, c_states, den, dh, dcs, dq, dk, dv, B, S, NH, qk_scale, eps,
        static_cast<cudaStream_t>(stream));
  });
}

// The whole backward: pass 1 into the scratch dcs, then pass 2.  Outputs dq,
// dk, dv in the dtype and dc0 float32.
extern "C" int chunkwise_bw(const void* q, const void* k, const void* v, const float* i,
                            const float* f, const float* c_states, const float* den,
                            const void* dh, const float* dc_last, void* dq, void* dk, void* dv,
                            float* dc0, void* dcs, int B, int S, int NH, int DH, int dtype,
                            float qk_scale, float eps, void* stream) {
  const int err = chunkwise_bw_dc(q, f, den, dh, dc_last, dcs, dc0, B, S, NH, DH, dtype,
                                  qk_scale, eps, stream);
  if (err) return err;
  return chunkwise_bw_dqkv(q, k, v, i, f, c_states, den, dh, dcs, dq, dk, dv, B, S, NH, DH,
                           dtype, qk_scale, eps, stream);
}
