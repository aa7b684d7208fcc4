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
//   sub-tile) from the states before and after the chunk, on the tensor
//   cores in bf16 with the quadratic backward's tile steps (parallel.cuh).
#pragma once

#include <math_constants.h>

#include "common.cuh"
#include "parallel.cuh"

namespace v1 {

using port::from_f32;
using port::NT;
using port::rt;
using port::to_f32;

constexpr int LMAX = 512;  // longest chunk
constexpr int TR = 64;     // rows of a tile: a chunk longer than this runs in sub-tiles

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__host__ __device__ constexpr int tile_rows(int L) { return L < TR ? L : TR; }

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

// The tiling of the dq/dk/dv kernel: 4 warps, each 16 of a block's TR own
// rows (the chunk's T_ = min(L, TR) rows of a sub-tile; at L 16 and 32 the
// warps past T_ only stage), the other side's sub-tiles in steps of QW
// columns (dk/dv).  Shared memory: the own tiles (dq: R(dhn); dk/dv: R(k),
// R(v)), the walk's two buffers of two tiles (dq: R(k), R(v); dk/dv: R(q),
// R(dhn)), which first hold the state (R(C_prev) or R(dC)), for dk/dv
// R(k kf), and the chunk's raw gate rows; its gate rows, two rows of den
// and each warp's score scratch (float32 products): 111 KB at DH 128 in
// bf16 (two blocks an SM), 228 KB in float32.
template <typename CT, int DH>
struct DqkvTile {
  static constexpr int LD = DH + tc::pad<CT>();
  static constexpr int QW = DH >= 128 ? 32 : 64;
  static constexpr int DQ_SCRATCH = par::scratch_floats<CT, TR / 8>();
  static constexpr int SCRATCH =  // floats of a warp's scratch: dq one fragment, dk/dv two
      DQ_SCRATCH > 2 * par::scratch_floats<CT, QW / 8>() ? DQ_SCRATCH
                                                         : 2 * par::scratch_floats<CT, QW / 8>();
  static constexpr size_t bytes =
      sizeof(CT) * 6 * TR * LD + 4 * (3 * LMAX + 2 * TR + par::NTC / 32 * SCRATCH);
};
static_assert(DqkvTile<float, 128>::bytes <= 232448, "a block's shared memory on Hopper");
static_assert((4 * TR - 128 - TR) * DqkvTile<__nv_bfloat16, 128>::LD * 2 >= 2 * LMAX * 4,
              "the raw gate rows fit in the walk's buffers beside the state and R(k kf)");
static_assert(DqkvTile<__nv_bfloat16, 128>::bytes <= 232448 / 2, "two blocks an SM");

// dq, dk, dv (in TO) of every chunk, independently, from the saved state
// before the chunk (C_prev) and the gradient of the state after it (dC):
// with dhn = dh / (den + eps), P = (R(dhn) R(v)^T) * D, SD = (R(q) R(k)^T
// scale) * D,
//   dq = R(P) R(k) scale + (R(dhn) R(C_prev)^T) qf scale
//   dk = R(P)^T R(q) scale + (R(v) R(dC)^T) kf
//   dv = R(SD)^T R(dhn) + R(k kf) R(dC)
// where qf = e^b, kf = e^a (v1) or qf = e^{(b + m_prev) - m_comb},
// kf = e^{a - m_new} (exp; m_prev, m_new from ms.mrow, m_comb per row: the
// forward's, so a sub-tile's D uses the whole row's stabilizer).
//
// Every (batch * head, chunk, sub-tile, part) is a block of 4 warps, part 0
// computing dq of the sub-tile's rows and part 1 dk and dv of its rows as
// keys.  A block stages its own rows and the state once; each warp first
// makes its rows' state product(s) on the tensor cores (R(dhn) R(C_prev)^T,
// or R(v) R(dC)^T and R(k kf) R(dC)), scaled per row into the accumulators
// (dk's by kf / scale, since the walk's sum is scaled by scale at the end),
// then walks the other side's sub-tiles of the chunk two deep by cp.async:
// dq the key sub-tiles up to its own (par::dq_step), dk/dv the query
// sub-tiles from its own on (par::dkv_step), with D from the chunk's gate
// rows, masked before the exp on the diagonal sub-tile.  Blocks go heaviest
// first: blockIdx.y counts the walk lengths down, dq's and dk/dv's blocks
// of one length side by side.
template <typename T, typename CT, int DH, bool EXP, typename TO>
__global__ void __launch_bounds__(par::NTC) dqkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg,
    const float* __restrict__ c_states, const float* __restrict__ den, const T* __restrict__ dh,
    const float* __restrict__ dc_states, TO* __restrict__ dq, TO* __restrict__ dk,
    TO* __restrict__ dv, int S, int L, float qk_scale, float eps, MState ms) {
  using Tl = DqkvTile<CT, DH>;
  constexpr int LD = Tl::LD, NJ = DH / 8, NTH = par::NTC;
  constexpr bool RAW = std::is_same<T, CT>::value;  // dh staged unchanged, scaled in place
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CT* own = reinterpret_cast<CT*>(smem_raw);  // 2 x (TR, LD): the own rows
  CT* wk = own + 2 * TR * LD;                 // 4 x (TR, LD): the walk's buffers
  float* sb = reinterpret_cast<float*>(wk + 4 * TR * LD);  // (LMAX) b of the chunk
  float* sli = sb + LMAX;                     // (LMAX) logsig(i) (exp: i)
  float* smc = sli + LMAX;                    // (LMAX) exp: m_comb
  float* sden = smc + LMAX;                   // 2 x (TR) den of staged dh rows
  float* scratch = sden + 2 * TR + threadIdx.x / 32 * Tl::SCRATCH;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int T_ = tile_rows(L);
  const int tiles = L / T_;
  const int NC = S / L;
  const int lvl = blockIdx.y / (2 * NC), c = blockIdx.y % NC;  // walks of tiles - lvl sub-tiles
  const bool part_q = (blockIdx.y / NC & 1) == 0;
  const int st = part_q ? tiles - 1 - lvl : lvl;
  const int bh = blockIdx.x;
  const size_t t0 = (size_t)bh * S + (size_t)c * L;  // first row of the chunk
  const size_t slot = (size_t)bh * NC + c;
  const int o0 = st * T_, l0 = 16 * warp;  // chunk rows of the own sub-tile, the warp's
  const bool active = l0 < T_;             // T_ is 16, 32 or 64: whole warps
  const float m_prev = EXP ? ms.mrow[slot * 2] : 0.f;
  const float m_new = EXP ? ms.mrow[slot * 2 + 1] : 0.f;
  const T* qc = q + t0 * DH;
  const T* kc = k + t0 * DH;
  const T* vc = v + t0 * DH;
  const T* dhc = dh + t0 * DH;
  const float* denc = den + t0;

  // the chunk's raw gate rows (rows the walk's buffers do not need yet) and
  // m_comb by cp.async with the tiles; chunk_gates turns them into b and
  // logsig(i) once they are in (gates_in)
  float* rfg = reinterpret_cast<float*>(wk + (DH + TR) * LD);
  float* rig = rfg + LMAX;
  for (int r = threadIdx.x; r < L; r += NTH) {
    tc::cp_async4(rfg + r, fg + t0 + r, true);
    tc::cp_async4(rig + r, ig + t0 + r, true);
    if (EXP) tc::cp_async4(smc + r, ms.m_comb + t0 + r, true);
  }
  auto gates_in = [&] {
    chunk_gates<EXP>(rig, rfg, L, sb, sli);
    __syncthreads();
  };
  // a sub-tile of dh (raw when T is CT, else R(dhn)) and its den rows into
  // dst and sd; rows past the sub-tile zero
  auto stage_dh = [&](CT* dst, float* sd, int p0) {
    par::stage_tile<T, CT, DH, LD, TR, NTH>(dst, dhc, p0, p0 + T_, RAW ? nullptr : denc, eps);
    for (int e = threadIdx.x; e < TR; e += NTH)
      tc::cp_async4(sd + e, e < T_ ? denc + p0 + e : denc, e < T_);
  };
  // R(dhn) in place once a raw dh sub-tile is in
  auto scale_dh = [&](CT* tile, const float* sd) {
    if constexpr (RAW) {
      par::scale_rows<CT, DH, LD, NTH>(tile, sd, eps);
      __syncthreads();
    }
  };
  const int row[2] = {o0 + l0 + g, o0 + l0 + g + 8};  // the lane's two own chunk rows
  float acc1[NJ][4], acc2[NJ][4];  // dq | dk, dv
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc1[j][x] = acc2[j][x] = 0.f;

  if (part_q) {
    stage_dh(own, sden, o0);
    par::stage_tile<float, CT, DH, LD, DH, NTH>(wk, c_states + slot * DH * DH, 0, DH);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    gates_in();
    scale_dh(own, sden);
    float rb[2] = {0.f, 0.f}, rm[2] = {0.f, 0.f};
    if (active) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)  // R(dhn) R(C_prev)^T
        tc::prod16<NJ, false, false>(acc1, own, LD, l0, wk, LD, 0, 16 * kk);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rb[hh] = sb[row[hh]];
        rm[hh] = EXP ? smc[row[hh]] : 0.f;
        const float qf = EXP ? expf((rb[hh] + m_prev) - rm[hh]) : expf(rb[hh]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc1[j][2 * hh] *= qf;
          acc1[j][2 * hh + 1] *= qf;
        }
      }
    }
    __syncthreads();  // the state's rows become the walk's buffers

    auto prefetch = [&](int kt, int buf) {
      par::stage_tile<T, CT, DH, LD, TR, NTH>(wk + buf * TR * LD, kc, kt * T_, kt * T_ + T_);
      par::stage_tile<T, CT, DH, LD, TR, NTH>(wk + (2 + buf) * TR * LD, vc, kt * T_,
                                              kt * T_ + T_);
      tc::cp_async_commit();
    };
    prefetch(0, 0);
    par::walk_tiles(0, st, prefetch, [](int, int) {}, [&](int kt, int buf) {
      if (!active) return;
      const int k0 = kt * T_;
      // the diagonal sub-tile masks j > l before the exp (and so the zero
      // columns past T_)
      auto step = [&](auto diag) {
        par::dq_step<DH>(acc1, own, l0, wk + buf * TR * LD, wk + (2 + buf) * TR * LD, LD,
                         scratch, [&](int hh, int cc) {
                           if (decltype(diag)::value && cc > l0 + g + 8 * hh)
                             return -CUDART_INF_F;
                           const float e = (rb[hh] - sb[k0 + cc]) + sli[k0 + cc];
                           return EXP ? e - rm[hh] : e;
                         });
      };
      if (kt == st) step(std::true_type{});
      else step(std::false_type{});
    });
    if (!active) return;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const size_t off = (t0 + row[hh]) * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        tc::st2(dq + off + 8 * j, acc1[j][2 * hh] * qk_scale, acc1[j][2 * hh + 1] * qk_scale);
    }
    return;
  }

  // dk, dv: the own R(k), R(v); R(dC) and R(k kf) in the walk's buffers
  CT* sk = own;
  CT* sv = own + TR * LD;
  CT* skf = wk + DH * LD;
  par::stage_tile<T, CT, DH, LD, TR, NTH>(sk, kc, o0, o0 + T_);
  par::stage_tile<T, CT, DH, LD, TR, NTH>(sv, vc, o0, o0 + T_);
  par::stage_tile<float, CT, DH, LD, DH, NTH>(wk, dc_states + slot * DH * DH, 0, DH);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  gates_in();
  const float gl = sb[L - 1];
  for (int e = threadIdx.x; e < TR * DH / 2; e += NTH) {
    const int r = e / (DH / 2), cc = 2 * (e - r * (DH / 2));
    float2 x = make_float2(0.f, 0.f);
    if (r < T_) {
      const int l = o0 + r;
      const float a = (gl - sb[l]) + sli[l];
      const float kf = expf(EXP ? a - m_new : a);
      if constexpr (RAW) x = tc::ld2(sk + r * LD + cc);  // k itself
      else x = tc::ld2(kc + (size_t)l * DH + cc);
      x.x *= kf;
      x.y *= kf;
    }
    tc::st2(skf + r * LD + cc, x.x, x.y);
  }
  __syncthreads();
  float bj[2] = {0.f, 0.f}, lj[2] = {0.f, 0.f};
  if (active) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      tc::prod16<NJ, false, false>(acc1, sv, LD, l0, wk, LD, 0, 16 * kk);   // R(v) R(dC)^T
      tc::prod16<NJ, false, true>(acc2, skf, LD, l0, wk, LD, 0, 16 * kk);   // R(k kf) R(dC)
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      bj[hh] = sb[row[hh]];
      lj[hh] = sli[row[hh]];
      const float a = (gl - bj[hh]) + lj[hh];
      const float kf = expf(EXP ? a - m_new : a) / qk_scale;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc1[j][2 * hh] *= kf;
        acc1[j][2 * hh + 1] *= kf;
      }
    }
  }
  __syncthreads();  // the state's rows become the walk's buffers

  auto prefetch = [&](int qt, int buf) {
    par::stage_tile<T, CT, DH, LD, TR, NTH>(wk + buf * TR * LD, qc, qt * T_, qt * T_ + T_);
    stage_dh(wk + (2 + buf) * TR * LD, sden + buf * TR, qt * T_);
    tc::cp_async_commit();
  };
  prefetch(st, 0);
  par::walk_tiles(
      st, tiles - 1, prefetch,
      [&](int, int buf) { scale_dh(wk + (2 + buf) * TR * LD, sden + buf * TR); },
      [&](int qt, int buf) {
        if (!active) return;
        const int p0 = qt * T_;
        // the diagonal sub-tile masks l < j, and the zero columns past T_,
        // before the exp
        auto step = [&](auto diag) {
          par::dkv_step<DH, Tl::QW>(
              acc1, acc2, sk, sv, l0, wk + buf * TR * LD, wk + (2 + buf) * TR * LD, LD, scratch,
              qk_scale, [&](int hh, int cc) {
                if (decltype(diag)::value && (cc < l0 + g + 8 * hh || cc >= T_))
                  return -CUDART_INF_F;
                const float e = (sb[p0 + cc] - bj[hh]) + lj[hh];
                return EXP ? e - smc[p0 + cc] : e;
              });
        };
        if (qt == st) step(std::true_type{});
        else step(std::false_type{});
      });
  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const size_t off = (t0 + row[hh]) * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      tc::st2(dk + off + 8 * j, acc1[j][2 * hh] * qk_scale, acc1[j][2 * hh + 1] * qk_scale);
      tc::st2(dv + off + 8 * j, acc2[j][2 * hh], acc2[j][2 * hh + 1]);
    }
  }
}

using port::dispatch;
using port::launch_with_smem;

inline bool chunk_ok(int S, int L) {
  return L >= 16 && L <= LMAX && (L & (L - 1)) == 0 && S > 0 && S % L == 0;
}

// Launches dqkv_kernel over B * NH heads of S rows in chunks of L; the CUDA
// error code.
template <typename T, typename CT, int DH, bool EXP, typename TO>
int launch_dqkv(const T* q, const T* k, const T* v, const float* i, const float* f,
                const float* c_states, const float* den, const T* dh, const float* dc_states,
                TO* dq, TO* dk, TO* dv, int BNH, int S, int L, float qk_scale, float eps,
                MState ms, cudaStream_t st) {
  const size_t smem = DqkvTile<CT, DH>::bytes;
  cudaError_t err = port::allow_smem(dqkv_kernel<T, CT, DH, EXP, TO>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BNH, 2 * (S / L) * (L / tile_rows(L)));
  dqkv_kernel<T, CT, DH, EXP, TO><<<grid, par::NTC, smem, st>>>(
      q, k, v, i, f, c_states, den, dh, dc_states, dq, dk, dv, S, L, qk_scale, eps, ms);
  return (int)cudaGetLastError();
}

}  // namespace v1
