// Shared pieces of the chunkwise mLSTM kernels in the (B, NH, S, DH) layout,
// sm_90a: the v1 route (chunkwise_v1_fw.cu, chunkwise_v1_bw.cu, sigmoid
// input gate) and the exp route (chunkwise_exp_fw.cu, chunkwise_exp_bw.cu,
// exponential input gate with the max stabilizer m).  Every kernel takes
// the gate as a template parameter EXP; with EXP = false it is the v1
// kernel as it was.
//
// Layout: q, k, v, h, dh (B * NH, S, DH) in the storage type T (float32 or
// bfloat16); gates i, f and the per-row den and m_comb (B * NH, S) float32;
// states (B * NH, NC, DH, DH) float32; m per chunk (B * NH, NC) float32.
// S is a multiple of the chunk length L.
//
// Rounding points.  The JAX kernels cast the operands of every product to
// their compute dtype and sum in float32; rt<CT>(x) rounds x to the compute
// type CT and back, at the same operands.  Row sums (the denominator, n)
// stay unrounded.
//
// Gates of one chunk, b = inclusive cumsum of logsig(f), g = b[L - 1]:
//   v1:  a = (g - b) + logsig(i),  D[l, j] = e^{(b_l - b_j) + logsig(i_j)}
//   exp: a = (g - b) + i,          D[l, j] = e^{((b_l - b_j) + i_j) - m_comb_l}
// where, with m_prev the stabilizer before the chunk,
//   m_comb_l = max(b_l + m_prev, max_{j <= l} ((b_l - b_j) + i_j))
// is the max over the whole row of the chunk (row_mcomb), and the state
// step is m_new = max(g + m_prev, max_l a_l), C and n scaled by
// e^{(g + m_prev) - m_new} and the new keys by e^{a - m_new}.
//
// - chunk_gates: the gate rows of one chunk in shared memory;
// - state_scan_kernel: the serial pass over the chunks of one (batch, head)
//   that carries a DH x DH state (the forward's C, n and m, or the
//   backward's dC), one block each;
// - h_kernel: h (and den, m_comb) of a (batch * head, chunk, 64-row
//   sub-tile) from the state before the chunk;
// - dqkv_kernel: dq, or dk and dv, of a (batch * head, chunk, 64-row
//   sub-tile) from the states before and after the chunk.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace v1 {

using port::from_f32;
using port::NT;
using port::rt;
using port::to_f32;

constexpr int LMAX = 512;  // longest chunk
constexpr int TR = 64;     // rows of a tile: a chunk longer than this runs in sub-tiles

// Rows of the dq/dk/dv kernel's tiles: 64, and 32 at DH = 128, where 64
// rows would need 271 KB of shared memory (163 KB at 32 rows).  Each sum
// runs over the same terms in ascending order whatever the tile, so the
// numbers do not depend on it.
template <int DH>
__host__ __device__ constexpr int dqkv_rows() { return DH >= 128 ? 32 : TR; }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__host__ __device__ constexpr int tile_rows(int L, int tr = TR) { return L < tr ? L : tr; }

// The m arrays of the exp route (all null on the v1 route).
struct MState {
  const float* m0;      // forward scan: m before the first chunk (B * NH), null for 0
  float* m_states;      // forward scan: m before each chunk (B * NH, NC) (out);
                        // h_kernel: the same (in)
  float* m_last;        // forward scan: m after the last chunk (B * NH) (out)
  const float* mrow;    // backward: per chunk [m_prev, gbar] (dC scan) or
                        // [m_prev, m_new] (dq/dk/dv), (B * NH, NC, 2)
  const float* m_comb;  // backward: the forward's m_comb per row (B * NH, S)
  float* mcomb_out;     // h_kernel: m_comb per row (out), null in predict
};

// sb[r] = sum_{t <= r} logsig(f[t]) and, if ig, sli[r] = logsig(i[r]) (EXP:
// the raw i[r]) for the L rows of one chunk (gates at fg, ig).  Warp 0
// works: each lane sums its run of ceil(L / 32) rows, then a shuffle scan
// adds the runs before it.  The caller synchronises the block.
template <bool EXP>
__device__ __forceinline__ void chunk_gates(const float* __restrict__ ig,
                                            const float* __restrict__ fg, int L, float* sb,
                                            float* sli) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (L + 31) / 32;
  const int r0 = min(lane * per, L), r1 = min(r0 + per, L);
  float run = 0.f;
  for (int r = r0; r < r1; ++r) {
    run += log_sigmoid(fg[r]);
    sb[r] = run;
    if (ig) sli[r] = EXP ? ig[r] : log_sigmoid(ig[r]);
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int r = r0; r < r1; ++r) sb[r] += excl;
}

// m_comb of chunk row l over the whole row (every column j <= l, not only
// a sub-tile's): the 4 consecutive lanes of a row (part = lane % 4) take
// every 4th column and combine with shuffles.  All 32 lanes of the warp
// call it (a warp holds 8 whole rows of a tile).
__device__ __forceinline__ float row_mcomb(const float* sb, const float* si, int l, float m_prev,
                                           int part) {
  const float bl = sb[l];
  float mx = -CUDART_INF_F;
  for (int j = part; j <= l; j += 4) mx = fmaxf(mx, (bl - sb[j]) + si[j]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  return fmaxf(bl + m_prev, mx);
}

// One block per (batch, head) walks its chunks, forward (BW = false) or in
// reverse (BW = true), carrying a DH x DH state in registers: thread t owns
// row t / (DH / EPT) and EPT consecutive columns.
//
//   forward:  stores C, n (EXP: m) before chunk c into states / n_states
//             (m_states), then
//               v1:  C <- e^g C + R(k e^a)^T R(v),  n <- e^g n + sum_l k_l e^{a_l}
//               exp: m_new = max(g + m, max_l a_l), gbar = e^{(g + m) - m_new},
//                    C <- gbar C + R(k e^{a - m_new})^T R(v), n likewise, m <- m_new;
//             x = k, y = v, s0 = c0, n0 (m0);  s_last = C, n_last = n (m_last)
//             after the last chunk
//   backward: stores dC after chunk c into states, then
//               dC <- gbar dC + R(q qf scale)^T R(dh / (den + eps)),
//             qf = e^b (v1; gbar = e^g) or e^{(b + m_prev) - m_comb} (exp; m_prev
//             and gbar from mrow); x = q, y = dh, s0 = dC_last;  s_last = dC0
//
// A chunk is read in tiles of TR rows staged in shared memory (dynamic:
// scan_smem_floats, 72 KB at DH = 128).
template <int DH>
constexpr size_t scan_smem_floats() {
  return 3 * LMAX          // b, logsig(i) (exp: i), the row factor
         + 2 * TR * (DH + 1)  // R(x * row factor), R(y)
         + 1;              // exp forward: m_new of the chunk
}

template <typename T, typename CT, int DH, bool BW, bool EXP>
__global__ void __launch_bounds__(NT) state_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const float* __restrict__ ig,
    const float* __restrict__ fg, const float* __restrict__ den, const float* __restrict__ s0,
    const float* __restrict__ n0, float* __restrict__ states, float* __restrict__ n_states,
    float* __restrict__ s_last, float* __restrict__ n_last, int S, int L, float qk_scale,
    float eps, MState ms) {
  constexpr int EPT = DH * DH / NT;  // state entries per thread
  constexpr int TPR = DH / EPT;      // threads per state row
  constexpr int DP = DH + 1;
  extern __shared__ float smem[];
  float* sb = smem;            // (LMAX)
  float* sli = sb + LMAX;      // (LMAX)
  float* sfac = sli + LMAX;    // (LMAX) the row factor: e^a (forward), e^b (backward), stabilized
  float* sa = sfac + LMAX;     // (TR, DP) R(x * row factor)
  float* sy = sa + TR * DP;    // (TR, DP) R(y), divided by den + eps in the backward
  float& smax = sy[TR * DP];   // exp forward: m_new of the chunk

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int dr = tid / TPR, dc0 = (tid % TPR) * EPT;
  const int NC = S / L;
  const int T_ = tile_rows(L);
  const size_t rows0 = (size_t)bh * S;  // row offset of this (batch, head)

  float st[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) st[e] = s0 ? s0[(size_t)bh * DH * DH + dr * DH + dc0 + e] : 0.f;
  float nst = (!BW && n0 && tid < DH) ? n0[(size_t)bh * DH + tid] : 0.f;
  float m = (EXP && !BW && ms.m0) ? ms.m0[bh] : 0.f;  // every thread holds the stabilizer

  for (int it = 0; it < NC; ++it) {
    const int c = BW ? NC - 1 - it : it;
    const size_t t0 = rows0 + (size_t)c * L;
    const size_t slot = (size_t)bh * NC + c;
#pragma unroll
    for (int e = 0; e < EPT; ++e) states[slot * DH * DH + dr * DH + dc0 + e] = st[e];
    if (!BW && tid < DH) n_states[slot * DH + tid] = nst;
    if (EXP && !BW && tid == 0) ms.m_states[slot] = m;

    chunk_gates<EXP>(BW ? nullptr : ig + t0, fg + t0, L, sb, sli);
    __syncthreads();
    const float g = sb[L - 1];
    float eg;
    if constexpr (!EXP) {
      for (int r = tid; r < L; r += NT) sfac[r] = BW ? expf(sb[r]) : expf((g - sb[r]) + sli[r]);
      eg = expf(g);
    } else if constexpr (BW) {
      const float m_prev = ms.mrow[slot * 2];
      eg = ms.mrow[slot * 2 + 1];
      for (int r = tid; r < L; r += NT) sfac[r] = expf((sb[r] + m_prev) - ms.m_comb[t0 + r]);
    } else {
      if (tid < 32) {  // m_new = max(g + m, max_l a_l)
        float mx = -CUDART_INF_F;
        for (int r = tid; r < L; r += 32) mx = fmaxf(mx, (g - sb[r]) + sli[r]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (tid == 0) smax = fmaxf(g + m, mx);
      }
      __syncthreads();
      const float m_new = smax;
      eg = expf((g + m) - m_new);
      for (int r = tid; r < L; r += NT) sfac[r] = expf(((g - sb[r]) + sli[r]) - m_new);
      m = m_new;
    }
    __syncthreads();

    float acc[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[e] = 0.f;
    float nacc = 0.f;
    for (int r0 = 0; r0 < L; r0 += T_) {
      for (int e = tid; e < T_ * DH; e += NT) {
        const int r = e / DH, d = e - r * DH;
        const size_t off = (t0 + r0 + r) * DH + d;
        const float a = BW ? (to_f32(x[off]) * sfac[r0 + r]) * qk_scale
                           : to_f32(x[off]) * sfac[r0 + r];
        const float b = BW ? to_f32(y[off]) / (den[t0 + r0 + r] + eps) : to_f32(y[off]);
        sa[r * DP + d] = rt<CT>(a);
        sy[r * DP + d] = rt<CT>(b);
      }
      if (!BW && tid < DH)  // n sums the unrounded k e^a
        for (int r = 0; r < T_; ++r)
          nacc = fmaf(to_f32(x[(t0 + r0 + r) * DH + tid]), sfac[r0 + r], nacc);
      __syncthreads();
      for (int r = 0; r < T_; ++r) {
        const float a = sa[r * DP + dr];
#pragma unroll
        for (int e = 0; e < EPT; ++e) acc[e] = fmaf(a, sy[r * DP + dc0 + e], acc[e]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) st[e] = fmaf(eg, st[e], acc[e]);
    if (!BW && tid < DH) nst = fmaf(eg, nst, nacc);
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e) s_last[(size_t)bh * DH * DH + dr * DH + dc0 + e] = st[e];
  if (!BW && tid < DH) n_last[(size_t)bh * DH + tid] = nst;
  if (EXP && !BW && tid == 0) ms.m_last[bh] = m;
}

template <int DH>
constexpr size_t h_smem_floats() {
  return 2 * LMAX                 // b, logsig(i) (exp: i)
         + 4 * TR * (DH + 1)      // R(q), qbar, R(k), R(v)
         + DH * (DH + 1) + DH     // R(C_prev), n_prev
         + TR * (TR + 1)          // sd tile
         + TR;                    // exp: m_comb of the tile's rows
}

// h of one (batch * head, chunk, TR-row sub-tile) from the state before the
// chunk (c_states, n_states; exp: m_states), walking the key sub-tiles at
// or before its own:
//   h   = (R(qbar) R(C_prev) + R(R(q) R(k)^T scale * D) R(v)) / (den + eps)
//   den = max(|qbar . n_prev + rowsum(R(q) R(k)^T scale * D)|, 1)   (v1)
//         max(|...|, e^{-m_comb})                                    (exp)
// with qbar = q e^b scale (v1) or q e^{(b + m_prev) - m_comb} scale (exp).
// den_out (and, exp, ms.mcomb_out) per row where not null.
template <typename T, typename CT, int DH, bool EXP>
__global__ void __launch_bounds__(NT) h_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg,
    const float* __restrict__ c_states, const float* __restrict__ n_states, T* __restrict__ h,
    float* __restrict__ den_out, int S, int L, float qk_scale, float eps, MState ms) {
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
  float* smc = ssd + TR * (TR + 1);  // (TR) exp: m_comb of the tile's rows

  const int tid = threadIdx.x;
  const int T_ = tile_rows(L);
  const int tiles = L / T_;
  const int c = blockIdx.x / tiles, st = blockIdx.x - c * tiles;
  const int bh = blockIdx.y;
  const int NC = S / L;
  const size_t t0 = (size_t)bh * S + (size_t)c * L;  // first row of the chunk
  const size_t slot = (size_t)bh * NC + c;
  const float m_prev = EXP ? ms.m_states[slot] : 0.f;

  chunk_gates<EXP>(ig + t0, fg + t0, L, sb, sli);
  for (int e = tid; e < DH * DH; e += NT)
    sC[(e / DH) * DP + e % DH] = rt<CT>(c_states[slot * DH * DH + e]);
  if (tid < DH) sn[tid] = n_states[slot * DH + tid];
  __syncthreads();
  const int q0 = st * T_;  // chunk row of the first query row
  const int row = tid / 4, cc = (tid % 4) * CPT;
  const bool has_row = row < T_;  // T_ is 16, 32 or 64: whole warps
  if constexpr (EXP) {
    if (has_row) {
      const float mc = row_mcomb(sb, sli, q0 + row, m_prev, tid % 4);
      if (tid % 4 == 0) smc[row] = mc;
    }
    __syncthreads();
  }
  for (int e = tid; e < T_ * DH; e += NT) {
    const int r = e / DH, d = e - r * DH;
    const float x = to_f32(q[(t0 + q0 + r) * DH + d]);
    sq[r * DP + d] = rt<CT>(x);
    sqb[r * DP + d] = EXP ? (x * expf((sb[q0 + r] + m_prev) - smc[r])) * qk_scale
                          : (x * expf(sb[q0 + r])) * qk_scale;
  }
  __syncthreads();

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
          const float ld = sb[l] - sb[j] + sli[j];
          ssd[(ti * 4 + r) * (TR + 1) + tj * 4 + s] =
              j <= l ? (acc[r][s] * qk_scale) * expf(EXP ? ld - smc[ti * 4 + r] : ld) : 0.f;
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
    const float floor_ = EXP ? expf(-smc[row]) : 1.f;
    const float den = fmaxf(fabsf(n_inter + n_intra), floor_);
    const size_t r = t0 + q0 + row;
    if (cc == 0 && den_out) den_out[r] = den;
    if (EXP && cc == 0 && ms.mcomb_out) ms.mcomb_out[r] = smc[row];
    const float inv = den + eps;
#pragma unroll
    for (int x = 0; x < CPT; ++x) from_f32((hi[x] + ha[x]) / inv, h + r * DH + cc + x);
  }
}

template <int DH>
constexpr size_t dqkv_smem_floats() {
  constexpr int TRD = dqkv_rows<DH>();
  return 3 * LMAX                 // b, logsig(i) (exp: i), exp: m_comb
         + 5 * TRD * (DH + 1)     // own-tile operands (3), other-tile operands (2)
         + DH * (DH + 1)          // R(C_prev) or R(dC)
         + 2 * TRD * (TRD + 1);   // P, SD tiles
}

// dq, dk, dv (in TO) of every chunk, independently, from the saved state
// before the chunk (C_prev) and the gradient of the state after it (dC):
// with dhn = dh / (den + eps), P = (R(dhn) R(v)^T) * D, SD = (R(q) R(k)^T
// scale) * D,
//   dq = R(P) R(k) scale + (R(dhn) R(C_prev)^T) qf scale
//   dk = R(P)^T R(q) scale + (R(v) R(dC)^T) kf
//   dv = R(SD)^T R(dhn) + R(k kf) R(dC)
// where qf = e^b, kf = e^a (v1) or qf = e^{(b + m_prev) - m_comb},
// kf = e^{a - m_new} (exp; m_prev, m_new from ms.mrow, m_comb per row).
//
// Every (batch * head, chunk, TRD-row sub-tile, part) is a block, part 0
// computing dq of the sub-tile's rows (walking the key sub-tiles at or
// before it) and part 1 dk and dv of its rows as keys (walking the query
// sub-tiles at or after it).
template <typename T, typename CT, int DH, bool EXP, typename TO>
__global__ void __launch_bounds__(NT) dqkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg,
    const float* __restrict__ c_states, const float* __restrict__ den, const T* __restrict__ dh,
    const float* __restrict__ dc_states, TO* __restrict__ dq, TO* __restrict__ dk,
    TO* __restrict__ dv, int S, int L, float qk_scale, float eps, MState ms) {
  constexpr int TRD = dqkv_rows<DH>();
  constexpr int DP = DH + 1;
  constexpr int TP = TRD + 1;
  constexpr int CPT = DH / 4;
  extern __shared__ float smem[];
  float* sb = smem;
  float* sli = sb + LMAX;
  float* smc = sli + LMAX;     // exp: m_comb of the chunk's rows
  float* sA = smc + LMAX;      // own rows: R(dhn) (dq) | R(k) (dk, dv)
  float* sB = sA + TRD * DP;    // own rows: unused    | R(v)
  float* sKa = sB + TRD * DP;   // own rows: unused    | R(k kf)
  float* sX = sKa + TRD * DP;   // other rows: R(v)    | R(q)
  float* sY = sX + TRD * DP;    // other rows: R(k)    | R(dhn)
  float* sS = sY + TRD * DP;    // (DH, DP) R(C_prev)  | R(dC)
  float* sP = sS + DH * DP;     // (TRD, TP) P
  float* sSD = sP + TRD * TP;   // (TRD, TP) SD (dk, dv only)

  const int tid = threadIdx.x;
  const int T_ = tile_rows(L, TRD);
  const int tiles = L / T_;
  const int c = blockIdx.x / tiles, st = blockIdx.x - c * tiles;
  const int bh = blockIdx.y;
  const bool part_q = blockIdx.z == 0;
  const int NC = S / L;
  const size_t t0 = (size_t)bh * S + (size_t)c * L;
  const size_t slot = (size_t)bh * NC + c;
  const int o0 = st * T_;  // chunk row of the block's own first row
  const float m_prev = EXP ? ms.mrow[slot * 2] : 0.f;
  const float m_new = EXP ? ms.mrow[slot * 2 + 1] : 0.f;

  chunk_gates<EXP>(ig + t0, fg + t0, L, sb, sli);
  if (EXP)
    for (int r = tid; r < L; r += NT) smc[r] = ms.m_comb[t0 + r];
  const float* state = part_q ? c_states : dc_states;
  for (int e = tid; e < DH * DH; e += NT)
    sS[(e / DH) * DP + e % DH] = rt<CT>(state[slot * DH * DH + e]);
  __syncthreads();
  const float g = sb[L - 1];
  for (int e = tid; e < T_ * DH; e += NT) {
    const int r = e / DH, d = e - r * DH;
    const size_t row = t0 + o0 + r;
    if (part_q) {
      sA[r * DP + d] = rt<CT>(to_f32(dh[row * DH + d]) / (den[row] + eps));
    } else {
      const float kx = to_f32(k[row * DH + d]);
      const float a = (g - sb[o0 + r]) + sli[o0 + r];
      sA[r * DP + d] = rt<CT>(kx);
      sB[r * DP + d] = rt<CT>(to_f32(v[row * DH + d]));
      sKa[r * DP + d] = rt<CT>(kx * expf(EXP ? a - m_new : a));
    }
  }
  __syncthreads();

  const int row = tid / 4, cc = (tid % 4) * CPT;
  const bool has_row = row < T_;
  float a1[CPT], a2[CPT], i1[CPT], i2[CPT];
#pragma unroll
  for (int x = 0; x < CPT; ++x) a1[x] = a2[x] = i1[x] = i2[x] = 0.f;
  if (has_row) {  // inter-chunk parts
#pragma unroll 4
    for (int u = 0; u < DH; ++u) {
      if (part_q) {  // R(dhn) R(C_prev)^T
        const float dn = sA[row * DP + u];
#pragma unroll
        for (int x = 0; x < CPT; ++x) i1[x] = fmaf(dn, sS[(cc + x) * DP + u], i1[x]);
      } else {  // R(v) R(dC)^T and R(k kf) R(dC)
        const float vu = sB[row * DP + u], ku = sKa[row * DP + u];
#pragma unroll
        for (int x = 0; x < CPT; ++x) {
          i1[x] = fmaf(vu, sS[(cc + x) * DP + u], i1[x]);
          i2[x] = fmaf(ku, sS[u * DP + cc + x], i2[x]);
        }
      }
    }
  }

  const int TT = T_ / 4;
  const int first = part_q ? 0 : st, last = part_q ? st : tiles - 1;
  for (int ot = first; ot <= last; ++ot) {
    const int p0 = ot * T_;  // chunk row of the other sub-tile
    for (int e = tid; e < T_ * DH; e += NT) {
      const int r = e / DH, d = e - r * DH;
      const size_t rr = t0 + p0 + r;
      if (part_q) {
        sX[r * DP + d] = rt<CT>(to_f32(v[rr * DH + d]));
        sY[r * DP + d] = rt<CT>(to_f32(k[rr * DH + d]));
      } else {
        sX[r * DP + d] = rt<CT>(to_f32(q[rr * DH + d]));
        sY[r * DP + d] = rt<CT>(to_f32(dh[rr * DH + d]) / (den[rr] + eps));
      }
    }
    __syncthreads();
    if (tid < TT * TT) {
      // tile rows are queries l, columns keys j: for dq the queries are the
      // own rows (P = sA sX^T); for dk, dv the keys are (P = sY sB^T,
      // SD = sX sA^T scale)
      const int ti = tid / TT, tj = tid % TT;
      const float* Lp = part_q ? sA : sY;  // query-side operand of P
      const float* Rp = part_q ? sX : sB;  // key-side operand of P
      float ap[4][4] = {}, as[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float la[4], rb[4], qa[4], kb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          la[r] = Lp[(ti * 4 + r) * DP + d];
          rb[r] = Rp[(tj * 4 + r) * DP + d];
          qa[r] = part_q ? 0.f : sX[(ti * 4 + r) * DP + d];
          kb[r] = part_q ? 0.f : sA[(tj * 4 + r) * DP + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            ap[r][s] = fmaf(la[r], rb[s], ap[r][s]);
            as[r][s] = fmaf(qa[r], kb[s], as[r][s]);
          }
      }
      const int lq0 = part_q ? o0 : p0, lk0 = part_q ? p0 : o0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = lq0 + ti * 4 + r;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = lk0 + tj * 4 + s;
          // the exponent is masked before exp: b_l - b_j > 0 above the diagonal
          const float ld = sb[l] - sb[j] + sli[j];
          const float dm = j <= l ? expf(EXP ? ld - smc[l] : ld) : 0.f;
          sP[(ti * 4 + r) * TP + tj * 4 + s] = ap[r][s] * dm;
          sSD[(ti * 4 + r) * TP + tj * 4 + s] = (as[r][s] * qk_scale) * dm;
        }
      }
    }
    __syncthreads();
    if (has_row) {
      if (part_q) {  // dq: sum_j R(P[row, j]) R(k_j)
        for (int j = 0; j < T_; ++j) {
          const float p = rt<CT>(sP[row * TP + j]);
#pragma unroll
          for (int x = 0; x < CPT; ++x) a1[x] = fmaf(p, sY[j * DP + cc + x], a1[x]);
        }
      } else {  // dk: sum_l R(P[l, row]) R(q_l); dv: sum_l R(SD[l, row]) R(dhn_l)
        for (int l = 0; l < T_; ++l) {
          const float p = rt<CT>(sP[l * TP + row]);
          const float s = rt<CT>(sSD[l * TP + row]);
#pragma unroll
          for (int x = 0; x < CPT; ++x) {
            a1[x] = fmaf(p, sX[l * DP + cc + x], a1[x]);
            a2[x] = fmaf(s, sY[l * DP + cc + x], a2[x]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (has_row) {
    const int l = o0 + row;
    const size_t off = (t0 + l) * DH + cc;
    if (part_q) {
      const float eb = (EXP ? expf((sb[l] + m_prev) - smc[l]) : expf(sb[l])) * qk_scale;
#pragma unroll
      for (int x = 0; x < CPT; ++x) from_f32(a1[x] * qk_scale + i1[x] * eb, dq + off + x);
    } else {
      const float a = (g - sb[l]) + sli[l];
      const float ea = expf(EXP ? a - m_new : a);
#pragma unroll
      for (int x = 0; x < CPT; ++x) {
        from_f32(a1[x] * qk_scale + i1[x] * ea, dk + off + x);
        from_f32(a2[x] + i2[x], dv + off + x);
      }
    }
  }
}

using port::dispatch;
using port::launch_with_smem;

inline bool chunk_ok(int S, int L) {
  return L >= 16 && L <= LMAX && (L & (L - 1)) == 0 && S > 0 && S % L == 0;
}

}  // namespace v1
