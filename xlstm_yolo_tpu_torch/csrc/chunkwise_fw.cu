// Chunkwise sigmoid-input-gate mLSTM forward for Hopper, sm_90a: inference,
// train and inference-with-LayerNorm variants.
//
// Replaces the TPU kernels `_fw_kernel_infer` (xlstm_yolo_tpu/ops/pallas/
// chunkwise_v2.py:245), `_fw_kernel_train` (:238) and `_fw_kernel_infer_ln`
// (:252), body `_fw_body` :130, and the host-side gate packing
// `_pack_gates` (:259).  Per chunk of L = 64 rows, with the gate rows b
// (within-chunk cumsum of logsig(f)), a = (g - b) + logsig(i), g = b[L - 1],
// D[l, j] = e^{b_l - b_j + logsig(i_j)} (j <= l), and R(x) the operand x of
// a product rounded to the compute type where `_fw_body` rounds it (JAX's
// .astype(dtype); the identity in float32):
//
//   SD    = (R(q) R(k)^T) * scale * D,   qbar = q e^b scale
//   h     = (R(qbar) R(C_prev) + R(SD) R(v)) / (den + eps)
//   den   = max(|qbar . n_prev + rowsum(SD)|, 1)
//   C    <- e^g C + R(k e^a)^T R(v),      n <- e^g n + sum_l k_l e^{a_l}
//
// everything but the four products' operands in float32.  The exponent of
// D is masked before exp: above the diagonal b_l - b_j > 0 overflows once
// the forget gates close.  The LN variant normalises each row's float32 h
// of each head before it is rounded (`_fw_body` :209-216): mean and centred
// variance over DH, (h - mean) rsqrt(var + ln_eps) lnw + lnb, with lnw the
// caller's (1 + w).  The train variant also stores, for the backward, the
// state before each chunk, C (B, NC, NH, DH, DH) and n (B, NC, NH, DH), and
// den (B, NC, NH, L), in float32 (den 1 on rows past S).
//
// Layout.  q, k, v are (B, S, NH*DH) rows with a row stride each (ldq, ldk,
// ldv: a split view of one projection is read in place; rows a multiple of
// 16 bytes apart), h is (B, S, NH*DH) contiguous: a head is a DH-wide column
// slice of each row, so no head transposes are made.  i and f are (B, S,
// NH) float32.  Ragged S is masked in the kernels: rows past S load as zero
// (never read out of range) and their gates are inert (logsig f = 0, logsig
// i = -inf); nothing is padded in device memory.
//
// What bounds it.  At B 8, S 6400, NH 6, DH 128 in bf16 the function reads
// q, k, v and writes h (315 MB) and, in the train variant, the states before
// each chunk (315 MB of float32 C): ~0.1 ms (~0.2 ms train) at 3.35 TB/s,
// against ~0.06 ms of products on the tensor cores: bound by bytes.
//
// Design: two passes, the products in the mma fragment layout (tc::prod16,
// csrc/mma.cuh): on the tensor cores (mma.sync m16n8k16, bf16 operands,
// float32 sums) for bf16, as float32 FMA for float32.  The only serial
// dependency is the state, so
//  1. fw_state_kernel, the state scan: one block of 4 warps per (batch,
//     head, 16 rows of C) walks the chunks forward (384 blocks at B 8, NH
//     6, DH 128), its C rows in float32 registers in the accumulator
//     layout, its 16 entries of n in float32.  Per chunk it stores the state
//     before the chunk (train: float32; inference: C in the storage type,
//     which is all its only reader uses, and n in float32), then C <- e^g C
//     + R(kbar[:, rows])^T R(v) on the mma, while the next chunk's k
//     columns, v and gates load with cp.async.  The last states in float32
//     at the end.
//  2. fw_out_kernel: one block of 4 warps per (batch, head, chunk), all
//     independent (4,800 blocks at B 8, S 6400, NH 6): q, k, v and C_prev
//     by cp.async (the train variant's float32 C_prev rounded to the
//     storage type on the way in); SD as a 64 x 64 product, the causal upper
//     half skipped; then h as a 64 x DH product.  Each warp owns 16 whole
//     rows, so n_intra, den and the LayerNorm's row statistics stay in the
//     warp.  Shared memory at DH 128: 96 KB in bf16 (two blocks an SM), 184
//     KB in float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "v2_gates.cuh"

namespace {

using port::from_f32;
using port::to_f32;
using tc::bf16;
using tc::ld2;
using tc::pad;
using tc::prod16;
using tc::st2;
using tc::sum_over_cols;
using v2::chunk_gates;

constexpr int L = 64;    // chunk rows
constexpr int TRW = 16;  // rows of C a block of the state scan owns
constexpr int NT1 = 128;  // threads of a state-scan block
constexpr int NT2 = 128;  // threads of an output block: 4 warps of 16 rows

template <typename T, int DH>
struct StateSmem {
  static constexpr int LDK = TRW + pad<T>(), LDV = DH + pad<T>();
  static constexpr size_t bytes =
      sizeof(T) * (2 * L * TRW + 2 * L * LDV + L * LDK) + 4 * (4 * L + 4 * L);
};

// One block per (batch * head, 16 rows i0.. of C); warp w holds columns
// 8 w NTW.. of its rows (DH 16: warps 0 and 1).  CS: the type of the
// stored states before each chunk (float: the train variant's).
template <typename T, int DH, typename CS>
__global__ void __launch_bounds__(NT1) fw_state_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ ig,
    const float* __restrict__ fg, const float* __restrict__ c0, const float* __restrict__ n0,
    CS* __restrict__ c_states, float* __restrict__ n_states, float* __restrict__ c_last,
    float* __restrict__ n_last, int S, int NH, int ldk, int ldv) {
  using Sm = StateSmem<T, DH>;
  constexpr int LDK = Sm::LDK, LDV = Sm::LDV;
  constexpr int NTW = DH >= 32 ? DH / 32 : 1;  // n-tiles of 8 columns a warp
  constexpr int E = 16 / sizeof(T);            // elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rk = reinterpret_cast<T*>(smem_raw);  // 2 x (L, TRW) k columns i0..
  T* rv = rk + 2 * L * TRW;                // 2 x (L, LDV) v
  T* skb = rv + 2 * L * LDV;               // (L, LDK) R(k e^a)
  float* rf = reinterpret_cast<float*>(skb + L * LDK);  // 2 x (L) f
  float* ri = rf + 2 * L;                  // 2 x (L) i
  float* sb = ri + 2 * L;
  float* seb = sb + L;
  float* sli = seb + L;
  float* sea = sli + L;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / NH, hd = bh - b * NH;
  const int i0 = blockIdx.y * TRW;
  const int NC = (S + L - 1) / L;
  const size_t gate0 = (size_t)b * S * NH + hd;
  const bool active = warp * NTW * 8 < DH;
  const int nc0 = warp * NTW * 8;  // the warp's first column
  const T* kb = k + (size_t)b * S * ldk + hd * DH + i0;
  const T* vb = v + (size_t)b * S * ldv + hd * DH;

  auto prefetch = [&](int c, int buf) {
    const int t0 = c * L;
    for (int e = tid; e < L * (TRW / E); e += NT1) {
      const int r = e / (TRW / E), cc = e - r * (TRW / E);
      const bool ok = t0 + r < S;
      tc::cp_async16(rk + buf * L * TRW + r * TRW + E * cc,
                     ok ? kb + (size_t)(t0 + r) * ldk + E * cc : k, ok);
    }
    for (int e = tid; e < L * (DH / E); e += NT1) {
      const int r = e / (DH / E), cc = e - r * (DH / E);
      const bool ok = t0 + r < S;
      tc::cp_async16(rv + buf * L * LDV + r * LDV + E * cc,
                     ok ? vb + (size_t)(t0 + r) * ldv + E * cc : v, ok);
    }
    for (int e = tid; e < L; e += NT1) {
      const bool ok = t0 + e < S;
      const size_t g = ok ? gate0 + (size_t)(t0 + e) * NH : 0;
      tc::cp_async4(rf + buf * L + e, fg + g, ok);
      tc::cp_async4(ri + buf * L + e, ig + g, ok);
    }
    tc::cp_async_commit();
  };

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = i0 + gq + 8 * (x >> 1), m = nc0 + 8 * j + 2 * tq + (x & 1);
      acc[j][x] = (active && c0) ? c0[((size_t)bh * DH + i) * DH + m] : 0.f;
    }
  float nn = (tid < TRW && n0) ? n0[(size_t)bh * DH + i0 + tid] : 0.f;

  prefetch(0, 0);
  for (int c = 0; c < NC; ++c) {
    const int buf = c & 1;
    const size_t chunk_bh = ((size_t)b * NC + c) * NH + hd;
    if (active) {  // the state before chunk c
      CS* out = c_states + chunk_bh * DH * DH;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st2(out + (size_t)(i0 + gq + 8 * h) * DH + nc0 + 8 * j + 2 * tq, acc[j][2 * h],
              acc[j][2 * h + 1]);
    }
    if (tid < TRW) n_states[chunk_bh * DH + i0 + tid] = nn;
    __syncthreads();  // every warp is done with the buffers the prefetch refills
    if (c + 1 < NC) {
      prefetch(c + 1, buf ^ 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (warp == 0) chunk_gates(rf + buf * L, ri + buf * L, S - c * L, sb, seb, sli, sea);
    __syncthreads();
    const T* ck = rk + buf * L * TRW;
    for (int e = tid; e < L * TRW; e += NT1) {
      const int r = e / TRW, col = e - r * TRW;
      from_f32(to_f32(ck[e]) * sea[r], skb + r * LDK + col);
    }
    if (tid < TRW) {  // n <- e^g n + sum_l k_l e^{a_l}, unrounded
      float s = 0.f;
      for (int r = 0; r < L; ++r) s += to_f32(ck[r * TRW + tid]) * sea[r];
      nn = seb[L - 1] * nn + s;
    }
    __syncthreads();
    if (active) {  // C <- e^g C + R(kbar)^T R(v)
      const float eg = seb[L - 1];
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[j][x] *= eg;
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk)
        prod16<NTW, true, true>(acc, skb, LDK, 0, rv + buf * L * LDV, LDV, nc0, 16 * kk);
    }
  }
  if (active)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = i0 + gq + 8 * (x >> 1), m = nc0 + 8 * j + 2 * tq + (x & 1);
        c_last[((size_t)bh * DH + i) * DH + m] = acc[j][x];
      }
  if (tid < TRW) n_last[(size_t)bh * DH + i0 + tid] = nn;
}

template <typename T, int DH>
struct OutSmem {
  static constexpr int LD = DH + pad<T>(), LDP = L + pad<T>();
  static constexpr size_t bytes = sizeof(T) * (3 * L * LD + DH * LD + L * LDP) + 4 * (DH + 7 * L);
};
static_assert(OutSmem<bf16, 128>::bytes <= 232448, "a block's shared memory on Hopper");
static_assert(OutSmem<float, 128>::bytes <= 232448, "a block's shared memory on Hopper");

// One block of 4 warps per (chunk, batch * head); warp w owns rows 16 w..
// of the chunk: of SD the columns up to its diagonal block, of h all DH.
// CS: the type of the stored states (float: the train variant's, rounded
// to T on the way in).  den: written where non-null.
template <typename T, int DH, typename CS, bool LN>
__global__ void __launch_bounds__(NT2) fw_out_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg,
    const CS* __restrict__ c_states, const float* __restrict__ n_states,
    const float* __restrict__ lnw, const float* __restrict__ lnb, T* __restrict__ h,
    float* __restrict__ den, int S, int NH, int ldq, int ldk, int ldv, float qk_scale,
    float eps, float ln_eps) {
  using Sm = OutSmem<T, DH>;
  constexpr int LD = Sm::LD, LDP = Sm::LDP;
  constexpr int NJ = DH / 8;  // n-tiles of 8 columns of h a warp (its rows whole)
  constexpr int E = 16 / sizeof(T);
  constexpr int CR = DH / E;  // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);  // (L, LD) q, then R(qbar)
  T* sk = sq + L * LD;                     // (L, LD) k
  T* sv = sk + L * LD;                     // (L, LD) v
  T* sC = sv + L * LD;                     // (DH, LD) R(C_prev)
  T* sSD = sC + DH * LD;                   // (L, LDP) R(SD)
  float* snp = reinterpret_cast<float*>(sSD + L * LDP);  // (DH) n_prev
  float* sf = snp + DH;
  float* si = sf + L;
  float* sb = si + L;
  float* seb = sb + L;
  float* sli = seb + L;
  float* sea = sli + L;
  float* sni = sea + L;  // n_inter per row

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / NH, hd = bh - b * NH;
  const int H = NH * DH, NC = (S + L - 1) / L;
  const int t0 = c * L, valid = min(L, S - t0);
  const size_t row0 = (size_t)b * S + t0;  // the chunk's first row
  const size_t gate0 = row0 * NH + hd;
  const size_t chunk_bh = ((size_t)b * NC + c) * NH + hd;
  const CS* cprev = c_states + chunk_bh * DH * DH;
  constexpr bool RAW_C = std::is_same<CS, T>::value;  // C_prev already in T

  for (int e = tid; e < 3 * L * CR; e += NT2) {
    const int which = e / (L * CR), f = e - which * (L * CR);
    const int r = f / CR, cc = f - r * CR;
    const bool ok = r < valid;
    const T* src = which == 0 ? q : which == 1 ? k : v;
    const int ld = which == 0 ? ldq : which == 1 ? ldk : ldv;
    tc::cp_async16(sq + which * L * LD + r * LD + E * cc,
                   ok ? src + (row0 + r) * ld + hd * DH + E * cc : src, ok);
  }
  if constexpr (RAW_C)
    for (int e = tid; e < DH * CR; e += NT2) {
      const int r = e / CR, cc = e - r * CR;
      tc::cp_async16(sC + r * LD + E * cc, cprev + (size_t)r * DH + E * cc, true);
    }
  for (int e = tid; e < DH / 4; e += NT2)
    tc::cp_async16(snp + 4 * e, n_states + chunk_bh * DH + 4 * e, true);
  for (int e = tid; e < L; e += NT2) {
    const bool ok = e < valid;
    tc::cp_async4(sf + e, fg + (ok ? gate0 + (size_t)e * NH : 0), ok);
    tc::cp_async4(si + e, ig + (ok ? gate0 + (size_t)e * NH : 0), ok);
  }
  tc::cp_async_commit();
  if constexpr (!RAW_C)  // the float32 state rounded to the storage type
    for (int e = tid; e < DH * DH / 4; e += NT2) {
      const float4 x = reinterpret_cast<const float4*>(cprev)[e];
      const int r = (4 * e) / DH, col = 4 * e - r * DH;
      st2(sC + r * LD + col, x.x, x.y);
      st2(sC + r * LD + col + 2, x.z, x.w);
    }
  tc::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) chunk_gates(sf, si, valid, sb, seb, sli, sea);
  __syncthreads();

  const int l0 = 16 * warp;
  // SD = (R(q) R(k)^T) * scale * D on the warp's rows, 16 columns at a
  // time up to the diagonal (the blocks above it are 0); n_intra from the
  // unrounded SD, R(SD) into shared memory for the warp's own reads
  float nintra[2] = {0.f, 0.f};
  {
    float aS[4][2][4];
#pragma unroll
    for (int np = 0; np < 4; ++np) {
#pragma unroll
      for (int j = 0; j < 2; ++j) aS[np][j][0] = aS[np][j][1] = aS[np][j][2] = aS[np][j][3] = 0.f;
      if (np <= warp)
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          prod16<2, false, false>(aS[np], sq, LD, l0, sk, LD, 16 * np, 16 * kk);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np > warp) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int l = l0 + gq + 8 * hh, col = 16 * np + 8 * j + 2 * tq;
          float sd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jj = col + e;
            // the exponent is masked before exp: b_l - b_j > 0 above the diagonal
            const float dm = jj <= l ? expf(sb[l] - sb[jj] + sli[jj]) : 0.f;
            sd[e] = aS[np][j][2 * hh + e] * qk_scale * dm;
            nintra[hh] += sd[e];
          }
          st2(sSD + l * LDP + col, sd[0], sd[1]);
        }
    }
  }
  __syncwarp();
  {  // the warp's rows of q -> R(q e^b scale) in place; n_inter = qbar . n_prev
    const int r = l0 + (lane >> 1), cb = (lane & 1) * (DH / 2);
    const float eb = seb[r];
    float dot = 0.f;
#pragma unroll 4
    for (int cc = 0; cc < DH / 2; cc += 2) {
      const float2 x = ld2(sq + r * LD + cb + cc);
      const float q0 = x.x * eb * qk_scale, q1 = x.y * eb * qk_scale;
      dot = fmaf(q0, snp[cb + cc], dot);
      dot = fmaf(q1, snp[cb + cc + 1], dot);
      st2(sq + r * LD + cb + cc, q0, q1);
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    if ((lane & 1) == 0) sni[r] = dot;
  }
  __syncwarp();

  // h = R(qbar) R(C_prev) + R(SD) R(v), the causal half of the SD sum skipped
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) prod16<NJ, false, true>(acc, sq, LD, l0, sC, LD, 0, 16 * kk);
#pragma unroll
  for (int kk = 0; kk < L / 16; ++kk) {
    if (kk > warp) break;
    prod16<NJ, false, true>(acc, sSD, LDP, l0, sv, LD, 0, 16 * kk);
  }

  float dv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int l = l0 + gq + 8 * hh;
    const float d = fmaxf(fabsf(sni[l] + sum_over_cols(nintra[hh])), 1.f);
    if (den && tq == 0) den[chunk_bh * L + l] = d;
    dv[hh] = d + eps;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] /= dv[x >> 1];
  if constexpr (LN) {  // per-head LayerNorm of each float32 row, before the rounding
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) s += acc[j][2 * hh] + acc[j][2 * hh + 1];
      const float mu = sum_over_cols(s) / DH;
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = acc[j][2 * hh + e] - mu;
          ss = fmaf(d, d, ss);
        }
      const float rstd = rsqrtf(sum_over_cols(ss) / DH + ln_eps);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = hd * DH + 8 * j + 2 * tq + e;
          acc[j][2 * hh + e] = (acc[j][2 * hh + e] - mu) * rstd * lnw[col] + lnb[col];
        }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int l = l0 + gq + 8 * hh;
      if (l < valid)
        st2(h + (row0 + l) * H + hd * DH + 8 * j + 2 * tq, acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
}

template <typename T, int DH, typename CS>
int launch_states(const void* k, const void* v, const float* i, const float* f, const float* c0,
                  const float* n0, void* cs, float* ns, float* cl, float* nl, int B, int S,
                  int NH, int ldk, int ldv, cudaStream_t st) {
  const size_t smem = StateSmem<T, DH>::bytes;
  cudaError_t err = port::allow_smem(fw_state_kernel<T, DH, CS>, smem);
  if (err != cudaSuccess) return (int)err;
  fw_state_kernel<T, DH, CS><<<dim3(B * NH, DH / TRW), NT1, smem, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), i, f, c0, n0, static_cast<CS*>(cs), ns,
      cl, nl, S, NH, ldk, ldv);
  return (int)cudaGetLastError();
}

template <typename T, int DH, typename CS, bool LN>
int launch_out(const void* q, const void* k, const void* v, const float* i, const float* f,
               const void* cs, const float* ns, const float* lnw, const float* lnb, void* h,
               float* den, int B, int S, int NH, int ldq, int ldk, int ldv, float qk_scale,
               float eps, float ln_eps, cudaStream_t st) {
  const size_t smem = OutSmem<T, DH>::bytes;
  cudaError_t err = port::allow_smem(fw_out_kernel<T, DH, CS, LN>, smem);
  if (err != cudaSuccess) return (int)err;
  fw_out_kernel<T, DH, CS, LN><<<dim3((S + L - 1) / L, B * NH), NT2, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), i, f,
      static_cast<const CS*>(cs), ns, lnw, lnb, static_cast<T*>(h), den, S, NH, ldq, ldk, ldv,
      qk_scale, eps, ln_eps);
  return (int)cudaGetLastError();
}

// Pass 1 for a dtype and head size: C states in float32 (train) or in the
// dtype.
int states(const void* k, const void* v, const float* i, const float* f, const float* c0,
           const float* n0, void* cs, float* ns, float* cl, float* nl, int B, int S, int NH,
           int DH, int ldk, int ldv, int dtype, bool train, cudaStream_t st) {
  // the compute type is the storage type
  return port::dispatch(dtype, dtype, DH, [&](auto t, auto, auto dh) -> int {
    using T = decltype(t);
    constexpr int D = decltype(dh)::value;
    if (train)
      return launch_states<T, D, float>(k, v, i, f, c0, n0, cs, ns, cl, nl, B, S, NH, ldk, ldv,
                                        st);
    return launch_states<T, D, T>(k, v, i, f, c0, n0, cs, ns, cl, nl, B, S, NH, ldk, ldv, st);
  });
}

// Pass 2: C states in float32 (cs_float) or in the dtype; with lnw the
// LayerNorm (C states in the dtype only).
int outputs(const void* q, const void* k, const void* v, const float* i, const float* f,
            const void* cs, const float* ns, const float* lnw, const float* lnb, void* h,
            float* den, int B, int S, int NH, int DH, int ldq, int ldk, int ldv, int dtype,
            bool cs_float, float qk_scale, float eps, float ln_eps, cudaStream_t st) {
  return port::dispatch(dtype, dtype, DH, [&](auto t, auto, auto dh) -> int {
    using T = decltype(t);
    constexpr int D = decltype(dh)::value;
    constexpr bool F32 = std::is_same<T, float>::value;
    if (lnw) {
      if (cs_float && !F32) return 1000;
      return launch_out<T, D, T, true>(q, k, v, i, f, cs, ns, lnw, lnb, h, den, B, S, NH, ldq,
                                       ldk, ldv, qk_scale, eps, ln_eps, st);
    }
    if (cs_float)
      return launch_out<T, D, float, false>(q, k, v, i, f, cs, ns, lnw, lnb, h, den, B, S, NH,
                                            ldq, ldk, ldv, qk_scale, eps, ln_eps, st);
    return launch_out<T, D, T, false>(q, k, v, i, f, cs, ns, lnw, lnb, h, den, B, S, NH, ldq,
                                      ldk, ldv, qk_scale, eps, ln_eps, st);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; q, k, v (B, S, NH * DH) in the dtype
// with row strides ldq, ldk, ldv (elements); i, f (B, S, NH) float32;
// c0 (B, NH, DH, DH) and n0 (B, NH, DH) float32 or null (zero initial
// state).  Every function returns the CUDA error code of its launch; 1000
// for an unsupported dtype or head size (the Python wrapper checks both
// before calling).  A forward is pass 1, then pass 2 on its states.

// Pass 1: the state before each chunk, c_states (B, NC, NH, DH, DH)
// in float32 (train) or in the dtype and n_states (B, NC, NH, DH) float32,
// and the last states c_last (B, NH, DH, DH), n_last (B, NH, DH) float32.
// ldq is not read (the pass reads no q).
extern "C" int chunkwise_fw_states(const void* k, const void* v, const float* i, const float* f,
                                   const float* c0, const float* n0, void* c_states,
                                   float* n_states, float* c_last, float* n_last, int B, int S,
                                   int NH, int DH, int ldq, int ldk, int ldv, int dtype,
                                   int train, void* stream) {
  (void)ldq;
  return states(k, v, i, f, c0, n0, c_states, n_states, c_last, n_last, B, S, NH, DH, ldk, ldv,
                dtype, train != 0, static_cast<cudaStream_t>(stream));
}

// Pass 2: h (B, S, NH * DH) in the dtype and den (B, NC, NH, L) float32
// (or null) from pass 1's states (c_states float32 with cs_float, else in
// the dtype); lnw, lnb (NH * DH) float32 or null (no LayerNorm).
extern "C" int chunkwise_fw_out(const void* q, const void* k, const void* v, const float* i,
                                const float* f, const void* c_states, const float* n_states,
                                const float* lnw, const float* lnb, void* h, float* den, int B,
                                int S, int NH, int DH, int ldq, int ldk, int ldv, int dtype,
                                int cs_float, float qk_scale, float eps, float ln_eps,
                                void* stream) {
  return outputs(q, k, v, i, f, c_states, n_states, lnw, lnb, h, den, B, S, NH, DH, ldq, ldk,
                 ldv, dtype, cs_float != 0, qk_scale, eps, ln_eps,
                 static_cast<cudaStream_t>(stream));
}
