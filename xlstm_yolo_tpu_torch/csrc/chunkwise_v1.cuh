// Shared pieces of the chunkwise mLSTM kernels in the (B, NH, S, DH) layout,
// sm_90a: the v1 route (chunkwise_v1_fw.cu, chunkwise_v1_bw.cu, sigmoid
// input gate) and the exp route (chunkwise_exp_fw.cu, chunkwise_exp_bw.cu,
// exponential input gate with the max stabilizer m).  Every kernel takes
// the gate as a template parameter EXP; with EXP = false it is the v1
// kernel.
//
// Layout: q, k, v, h, dh (B * NH, S, DH) in the storage type T (float32 or
// bfloat16); gates i, f and the per-row den and m_comb (B * NH, S) float32;
// states (B * NH, NC, DH, DH) float32; m per chunk (B * NH, NC) float32.
// S is a multiple of the chunk length L.
//
// Rounding points.  The JAX kernels cast the operands of every product to
// their compute dtype and sum in float32; R(x) rounds x to the compute
// type CT at the same operands (on the way into shared memory, or packing
// a fragment to bf16).  Row sums (the denominator, n) stay
// unrounded.
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
// - fw_scan_kernel: the forward's state pass, C, n (exp: m) before each
//   chunk and after the last; a block of 4 warps per (batch * head, 16 rows
//   of C) walks the chunks in 64-row tiles, the chunk's update on the
//   tensor cores;
// - fw_h_kernel: the forward's output pass, h (and den, m_comb) of a
//   (batch * head, chunk, 64-row sub-tile) from the state before the chunk:
//   the quadratic forward's loop (parallel_fw.cu) confined to the chunk,
//   plus the inter-chunk product in the same accumulators;
// - dc_inc_kernel, dc_combine_kernel: the backward's dC scan in two
//   passes, every chunk's increment R(qbar)^T R(dhn) at once on the tensor
//   cores (a block of 4 warps per (min(DH, 64) rows of dC, chunk,
//   batch * head)),
//   then the reverse scale-and-add of the increments, elementwise;
// - dqkv_kernel: dq, or dk and dv, of a (batch * head, chunk, 64-row
//   sub-tile) from the states before and after the chunk, on the tensor
//   cores in bf16 with the quadratic backward's tile steps (parallel.cuh).
// The forward's two kernels also run fw3, the sub-chunked forward
// (chunkwise_fw3.cu), with their F3 parameter set: they then walk fw3's
// sub-chunks as their chunks, in its (B, S, NH * DH) layout (Sub).
// The tensor-core kernels run their products through tc::prod16 and
// par::score_times: mma.sync m16n8k16 with bf16 operands and float32 sums
// for CT = bf16, the same tiling as float32 FMA for CT = float.
#pragma once

#include <math_constants.h>

#include <type_traits>

#include "common.cuh"
#include "parallel.cuh"

namespace v1 {

using port::from_f32;
using port::NT;
using port::to_f32;

constexpr int LMAX = 512;  // longest chunk
constexpr int TR = 64;     // rows of a tile: a chunk longer than this runs in sub-tiles

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__host__ __device__ constexpr int tile_rows(int L) { return L < TR ? L : TR; }

// fw3's sub-chunks, which fw_scan_kernel and fw_h_kernel walk as their
// chunks when F3 is set (the defaults: the v1 and exp routes).  q, k, v and
// h are (B, S, NH * DH) rows, a head a DH-wide column slice of each; chunk
// c is the sub-chunk of the Lb rows from c Lb, walked as the kernels' L
// rows (Lb rounded up to whole tiles), its rows past Lb or S loaded as
// zeros.  The gate rows come made, one set for both passes, with a carry
// over 64-row tiles (fw3_gates_kernel), so no pass holds a sub-chunk's
// gates: a tile's rows arrive with the tile.  The state before each
// sub-chunk goes to the (B, NS, NH) slots of c_states, C in the compute
// type (all the output pass reads); the train variant also stores every
// NB-th in float32 (cstates) and den by chunk (n_out).
struct Sub {
  int NH = 1;                  // heads a row of q, k, v and h holds
  int Lb = 0;                  // rows of a sub-chunk
  int NB = 1;                  // sub-chunks a chunk
  int NS = 0;                  // sub-chunks: NB times the chunks, the last rows past S
  const float* b = nullptr;    // (B * NH, NS, L) b from the sub-chunk's start
  const float* li = nullptr;   // (B * NH, NS, L) logsig(i), -inf past Lb and S
  const float* fac = nullptr;  // (B * NH, NS, L) e^a, 0 there
  const float* eg = nullptr;   // (B * NH, NS) e^g
  float* cstates = nullptr;    // (B, NS / NB, NH, DH, DH) float32, or null
  float* n_out = nullptr;      // (B, NS / NB, NH, NB Lb) den, or null
};

// The type of the stored states before each chunk: float32 on the v1 and
// exp routes, the compute type for fw3.
template <typename CT, bool F3>
using StateT = typename std::conditional<F3, CT, float>::type;

// The m arrays of the exp route (all null on the v1 route).
struct MState {
  const float* m0;      // state pass: m before the first chunk (B * NH), null for 0
  float* m_states;      // state pass: m before each chunk (B * NH, NC) (out);
                        // output pass: the same (in)
  float* m_last;        // state pass: m after the last chunk (B * NH) (out)
  const float* mrow;    // backward: per chunk [m_prev, gbar] (dC scan) or
                        // [m_prev, m_new] (dq/dk/dv), (B * NH, NC, 2)
  const float* m_comb;  // backward: the forward's m_comb per row (B * NH, S)
  float* mcomb_out;     // output pass: m_comb per row (out), null in predict
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
// call it (a warp holds 8 whole rows of a fragment).
__device__ __forceinline__ float row_mcomb(const float* sb, const float* si, int l, float m_prev,
                                           int part) {
  const float bl = sb[l];
  float mx = -CUDART_INF_F;
  for (int j = part; j <= l; j += 4) mx = fmaxf(mx, (bl - sb[j]) + si[j]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  return fmaxf(bl + m_prev, mx);
}

// The state pass's tiling: a block of 4 warps per (batch * head, TRW rows
// i0.. of C), warp w holding columns 8 w NTW.. of those rows (DH 16: warps
// 0 and 1).  Shared memory: a tile's R(v) and raw k columns i0.., two deep;
// R(kbar) of those columns; the chunk's raw and scanned gate rows and row
// factors (F3: a tile's row factors, two deep, and e^g): 52 KB at DH 128 in
// bf16, 91 KB in float32.
template <typename T, typename CT, int DH, bool F3 = false>
struct ScanTile {
  static constexpr int TRW = 16;                      // rows of C a block owns
  static constexpr int NTW = DH >= 32 ? DH / 32 : 1;  // n-tiles of 8 columns a warp
  static constexpr int LDK = TRW + tc::pad<CT>(), LDV = DH + tc::pad<CT>();
  static constexpr int GATES = F3 ? 2 * TR + 2 : 5 * LMAX;  // floats of the gate rows
  static constexpr size_t bytes = sizeof(CT) * (2 * TR * LDV + TR * LDK) +
                                  sizeof(T) * 2 * TR * TRW + 4 * (GATES + 4 * TRW + 1);
};

// The forward's state pass.  Per chunk c the block stores rows i0.. of the
// state before it, C and n (exp: one block of the head also m), in float32
// (F3: C in CT, and every NB-th C also in float32), then
//   v1:  C <- e^g C + R(k e^a)^T R(v),  n <- e^g n + sum_l k_l e^{a_l}
//   exp: m_new = max(g + m, max_l a_l), gbar = e^{(g + m) - m_new},
//        C <- gbar C + R(k e^{a - m_new})^T R(v), n likewise, m <- m_new
// and after the last chunk c_last, n_last (m_last).  C lives in float32
// registers in the accumulator layout, scaled by e^g (gbar) once the
// chunk's gates are in, the increment's products summing into it.  Every
// block of a head computes the same m from the gates alone, so a chunk's
// keys are scaled by the m_new of the whole head before they are rounded.
// A chunk is read in tiles of T_ = min(L, 64) rows: the next tile's v, k
// columns (and, at a chunk's first tile, its gates; F3: every tile's row
// factors e^a, and e^g with the first) load by cp.async while the current
// one is scaled, rounded and multiplied (R(kbar)^T R(v), 16 rows a step); n
// sums the unrounded kbar, each thread one column's rows of a tile, the
// warps' sums meeting once a chunk.  The launch bounds ask for at least one
// block an SM: without that minimum ptxas squeezed the DH 128 instantiation
// into 128 registers with spills.
template <typename T, typename CT, int DH, bool EXP, bool F3 = false>
__global__ void __launch_bounds__(par::NTC, 1) fw_scan_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ ig,
    const float* __restrict__ fg, const float* __restrict__ c0, const float* __restrict__ n0,
    StateT<CT, F3>* __restrict__ c_states, float* __restrict__ n_states,
    float* __restrict__ c_last, float* __restrict__ n_last, int S, int L, MState ms, Sub sub) {
  using Tl = ScanTile<T, CT, DH, F3>;
  constexpr int TRW = Tl::TRW, NTW = Tl::NTW, LDK = Tl::LDK, LDV = Tl::LDV, NTH = par::NTC;
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CT* sv = reinterpret_cast<CT*>(smem_raw);      // 2 x (TR, LDV) R(v) of a tile
  CT* skb = sv + 2 * TR * LDV;                   // (TR, LDK) R(kbar), columns i0..
  T* rk = reinterpret_cast<T*>(skb + TR * LDK);  // 2 x (TR, TRW) k, columns i0..
  float* fb = reinterpret_cast<float*>(rk + 2 * TR * TRW);
  float* rfg = fb;                        // (LMAX) f of the chunk
  float* rig = rfg + LMAX;                // (LMAX) i
  float* sb = rig + LMAX;                 // (LMAX) b
  float* sli = sb + LMAX;                 // (LMAX) logsig(i) (exp: i)
  float* sfac = F3 ? fb : sli + LMAX;     // (LMAX) e^a (exp: e^{a - m_new}); F3: 2 x (TR)
  float* seg = fb + 2 * TR;               // F3: e^g, two slots
  float* sn = fb + Tl::GATES;             // (4, TRW) each warp's sums of kbar
  float* smax = sn + 4 * TRW;             // exp: m_new of the chunk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, i0 = blockIdx.y * TRW;
  const int NC = F3 ? sub.NS : S / L, T_ = tile_rows(L), tiles = L / T_;
  const bool active = warp * NTW * 8 < DH;
  const int nc0 = warp * NTW * 8;  // the warp's first column of C
  const bool writes_m = EXP && blockIdx.y == 0 && tid == 0;
  const size_t rows0 = (size_t)bh * S;
  // F3: batch hb, head hd of the (B, S, NH * DH) rows, ld elements apart
  const int hb = F3 ? bh / sub.NH : bh, hd = F3 ? bh - hb * sub.NH : 0;
  const int ld = F3 ? sub.NH * DH : DH;
  const T* kb = F3 ? k + (size_t)hb * S * ld + hd * DH + i0 : k + rows0 * DH + i0;
  const T* vb = F3 ? v + (size_t)hb * S * ld + hd * DH : v + rows0 * DH;

  // tile tt of chunk c into buffer buf, with the chunk's gates at its first
  // (F3: the tile's row factors, and e^g with the first; rows past the
  // sub-chunk or S zero)
  auto prefetch = [&](int c, int tt, int buf) {
    if constexpr (F3) {
      const int c0r = c * sub.Lb;                         // the sub-chunk's first row
      const int nv = max(0, min(sub.Lb, S - c0r)), r0 = tt * T_;  // its rows with data
      for (int e = tid; e < T_ * (TRW / E); e += NTH) {
        const int r = e / (TRW / E), cc = E * (e - r * (TRW / E));
        const bool ok = r0 + r < nv;
        tc::cp_async16(rk + (buf * TR + r) * TRW + cc,
                       ok ? kb + (size_t)(c0r + r0 + r) * ld + cc : kb, ok);
      }
      par::stage_tile<T, CT, DH, LDV, TR, NTH>(sv + buf * TR * LDV, vb + (size_t)c0r * ld, r0,
                                               min(r0 + T_, nv), nullptr, 0.f, ld);
      const size_t gr = ((size_t)bh * NC + c) * L + r0;
      for (int r = tid; r < T_; r += NTH) tc::cp_async4(sfac + buf * TR + r, sub.fac + gr + r, true);
      if (tt == 0 && tid == 0) tc::cp_async4(seg + (c & 1), sub.eg + (size_t)bh * NC + c, true);
    } else {
      const int r0 = c * L + tt * T_;
      for (int e = tid; e < T_ * (TRW / E); e += NTH) {
        const int r = e / (TRW / E), cc = E * (e - r * (TRW / E));
        tc::cp_async16(rk + (buf * TR + r) * TRW + cc, kb + (size_t)(r0 + r) * DH + cc, true);
      }
      par::stage_tile<T, CT, DH, LDV, TR, NTH>(sv + buf * TR * LDV, vb, r0, r0 + T_);
      if (tt == 0)
        for (int r = tid; r < L; r += NTH) {
          tc::cp_async4(rfg + r, fg + rows0 + r0 + r, true);
          tc::cp_async4(rig + r, ig + rows0 + r0 + r, true);
        }
    }
    tc::cp_async_commit();
  };

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = i0 + g + 8 * (x >> 1), m = nc0 + 8 * j + 2 * t + (x & 1);
      acc[j][x] = (active && c0) ? c0[((size_t)bh * DH + i) * DH + m] : 0.f;
    }
  float nn = (tid < TRW && n0) ? n0[(size_t)bh * DH + i0 + tid] : 0.f;
  float m = (EXP && ms.m0) ? ms.m0[bh] : 0.f;  // every thread holds the stabilizer
  const int col = tid % TRW;  // the k column this thread scales (NTH is a multiple of TRW)

  prefetch(0, 0, 0);
  for (int c = 0; c < NC; ++c) {
    // the slot of the state before chunk c: (B * NH, NC); F3 (B, NS, NH)
    const size_t slot = F3 ? ((size_t)hb * NC + c) * sub.NH + hd : (size_t)bh * NC + c;
    if (active) {  // the state before chunk c
      StateT<CT, F3>* out = c_states + slot * DH * DH;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          tc::st2(out + (size_t)(i0 + g + 8 * hh) * DH + nc0 + 8 * j + 2 * t, acc[j][2 * hh],
                  acc[j][2 * hh + 1]);
      if constexpr (F3)
        if (sub.cstates && c % sub.NB == 0) {  // every NB-th also in float32
          float* o = sub.cstates + (((size_t)hb * (NC / sub.NB) + c / sub.NB) * sub.NH + hd) * DH * DH;
#pragma unroll
          for (int j = 0; j < NTW; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              tc::st2(o + (size_t)(i0 + g + 8 * hh) * DH + nc0 + 8 * j + 2 * t, acc[j][2 * hh],
                      acc[j][2 * hh + 1]);
        }
    }
    if (tid < TRW) n_states[slot * DH + i0 + tid] = nn;
    if (writes_m) ms.m_states[slot] = m;
    float npart = 0.f, eg = 0.f;
    for (int tt = 0; tt < tiles; ++tt) {
      const int buf = (c * tiles + tt) & 1;
      tc::cp_async_wait<0>();
      __syncthreads();  // tile tt is in; every warp is done with the other buffer
      if constexpr (F3) {
        if (tt == 0) {  // the sub-chunk's e^g came with its first tile
          eg = seg[c & 1];
#pragma unroll
          for (int j = 0; j < NTW; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) acc[j][x] *= eg;
        }
      } else if (tt == 0) {  // the chunk's gate rows, m_new and row factors
        chunk_gates<EXP>(rig, rfg, L, sb, sli);
        __syncthreads();
        const float gl = sb[L - 1];
        float m_new = 0.f;
        if constexpr (EXP) {  // m_new = max(g + m, max_l a_l)
          if (warp == 0) {
            float mx = -CUDART_INF_F;
            for (int r = lane; r < L; r += 32) mx = fmaxf(mx, (gl - sb[r]) + sli[r]);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            if (lane == 0) *smax = fmaxf(gl + m, mx);
          }
          __syncthreads();
          m_new = *smax;
          eg = expf((gl + m) - m_new);
          m = m_new;
        } else {
          eg = expf(gl);
        }
        for (int r = tid; r < L; r += NTH) {
          const float a = (gl - sb[r]) + sli[r];
          sfac[r] = expf(EXP ? a - m_new : a);
        }
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[j][x] *= eg;
        __syncthreads();
      }
      if (tt + 1 < tiles) prefetch(c, tt + 1, buf ^ 1);
      else if (c + 1 < NC) prefetch(c + 1, 0, buf ^ 1);
      const T* ck = rk + buf * TR * TRW;
      for (int e = tid; e < T_ * TRW; e += NTH) {
        const int r = e / TRW;
        const float x = to_f32(ck[e]) * (F3 ? sfac[buf * TR + r] : sfac[tt * T_ + r]);
        npart += x;
        from_f32(x, skb + r * LDK + col);
      }
      __syncthreads();
      if (active)
        for (int kk = 0; kk < T_ / 16; ++kk)
          tc::prod16<NTW, true, true>(acc, skb, LDK, 0, sv + buf * TR * LDV, LDV, nc0, 16 * kk);
    }
    npart += __shfl_xor_sync(0xffffffffu, npart, 16);
    if (lane < TRW) sn[warp * TRW + lane] = npart;
    __syncthreads();
    if (tid < TRW) nn = fmaf(eg, nn, (sn[tid] + sn[TRW + tid]) + (sn[2 * TRW + tid] + sn[3 * TRW + tid]));
  }
  if (active)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = i0 + g + 8 * (x >> 1), mc = nc0 + 8 * j + 2 * t + (x & 1);
        c_last[((size_t)bh * DH + i) * DH + mc] = acc[j][x];
      }
  if (tid < TRW) n_last[(size_t)bh * DH + i0 + tid] = nn;
  if (writes_m) ms.m_last[bh] = m;
}

// The output pass's tiling: 4 warps, each 16 of a block's TR query rows
// (the chunk's T_ rows of a sub-tile; at L 16 and 32 the warps past T_
// only stage).  Shared memory: R(q) of the own rows; the walk's two
// buffers of R(k) and R(v), whose second first holds R(C_prev) and R(qbar)
// (at DH 128 they reach into the first); the chunk's raw and scanned gate
// rows (F3: b and logsig(i) of the walk's two tiles and b of the own rows),
// n_prev, and each warp's score scratch (float32 products): 96 KB at DH 128
// in bf16 (two blocks an SM), 195 KB in float32.
template <typename CT, int DH, bool F3 = false>
struct OutTile {
  static constexpr int LD = DH + tc::pad<CT>();
  static constexpr bool EARLY = DH <= TR;  // the state leaves buffer 0 to the first key tile
  static constexpr int SCRATCH = par::scratch_floats<CT, TR / 8>();
  static constexpr int GATES = F3 ? 5 * TR : 4 * LMAX;  // floats of the gate rows
  static constexpr size_t bytes =
      sizeof(CT) * 5 * TR * LD + 4 * (GATES + DH + par::NTC / 32 * SCRATCH);
};
static_assert(OutTile<float, 128>::bytes <= 232448, "a block's shared memory on Hopper");
static_assert(OutTile<__nv_bfloat16, 128>::bytes <= 232448 / 2, "two blocks an SM");

// h of one (batch * head, chunk, T_-row sub-tile) from the state before the
// chunk (c_states, n_states; exp: m_states):
//   h   = (R(qbar) R(C_prev) + R((R(q) R(k)^T scale) D) R(v)) / (den + eps)
//   den = max(|qbar . n_prev + rowsum((R(q) R(k)^T scale) D)|, 1)    (v1)
//         max(|...|, e^{-m_comb})                                    (exp)
// with qbar = (q e^b) scale (v1) or (q e^{(b + m_prev) - m_comb}) scale
// (exp), rounded itself (not R(q) times the factor: scale is not a power
// of two).  den_out (and, exp, ms.mcomb_out) per row where not null; F3:
// den into sub.n_out, h and den of the sub-chunk's Lb rows only (h of
// those before S).
//
// A block stages R(q) of its rows, R(C_prev), n_prev and the chunk's raw
// gates in one cp.async group (through registers, rounding, where the
// storage type is not the compute type), and turns the gates into b and
// logsig(i) (F3: b of its rows, made).  Each warp then takes m_comb of its
// rows over the whole row of the chunk (row_mcomb, exp), stages R(qbar) of
// its own rows, sums n_inter from the unrounded qbar, and makes R(qbar)
// R(C_prev) on the tensor cores into the accumulators of h.  Then it walks
// the key sub-tiles up to its own, staged two deep by cp.async
// (par::walk_tiles; F3: with their gate rows), as parallel_fw_kernel walks
// its key tiles: the (16 x TR) fragment R(q) R(k)^T, scaled in registers to
// (s scale) D with one __expf a pair (only the diagonal sub-tile masked,
// the exponent before the exp, which also masks the zero columns past T_),
// its row sums for den, and the fragment packed to bf16 as the A operand of
// the product with R(v) (par::score_times): no score tile goes to shared
// memory.  Blocks go heaviest first: blockIdx.y counts the walk lengths
// down (F3: blockIdx.y + 65535 blockIdx.z, past 65535 blocks).
template <typename T, typename CT, int DH, bool EXP, bool F3 = false>
__global__ void __launch_bounds__(par::NTC) fw_h_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg,
    const StateT<CT, F3>* __restrict__ c_states, const float* __restrict__ n_states,
    T* __restrict__ h, float* __restrict__ den_out, int S, int L, float qk_scale, float eps,
    MState ms, Sub sub) {
  using Tl = OutTile<CT, DH, F3>;
  constexpr int LD = Tl::LD, NS = TR / 8, NJ = DH / 8, NTH = par::NTC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CT* sq = reinterpret_cast<CT*>(smem_raw);  // (TR, LD) R(q)
  CT* wk = sq + TR * LD;                     // buffer b: R(k) at 2 b TR rows, R(v) after it
  CT* sqb = wk + 3 * TR * LD;                // (TR, LD) R(qbar), until the walk
  CT* sC = sqb - DH * LD;                    // (DH, LD) R(C_prev), until the walk
  float* fb = reinterpret_cast<float*>(wk + 4 * TR * LD);
  float* rfg = fb;          // (LMAX) f of the chunk
  float* rig = rfg + LMAX;  // (LMAX) i
  float* sb = rig + LMAX;   // (LMAX) b
  float* sli = sb + LMAX;   // (LMAX) logsig(i) (exp: i)
  float* sgb = fb;          // F3: 2 x (TR) b of the walk's tiles
  float* sgl = fb + 2 * TR;  // F3: 2 x (TR) their logsig(i)
  float* sob = fb + 4 * TR;  // F3: (TR) b of the own rows
  float* sn = fb + Tl::GATES;  // (DH) n_prev
  float* scratch = sn + DH + threadIdx.x / 32 * Tl::SCRATCH;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int T_ = tile_rows(L), tiles = L / T_, NC = F3 ? sub.NS : S / L;
  const int yid = F3 ? blockIdx.y + 65535 * blockIdx.z : blockIdx.y;
  if (F3 && yid >= NC * tiles) return;
  const int lvl = yid / NC, c = yid - lvl * NC;
  const int st = tiles - 1 - lvl;  // the sub-tile: the longest walks first
  const int bh = blockIdx.x;
  // F3: batch hb, head hd of the (B, S, NH * DH) rows, ld elements apart
  const int hb = F3 ? bh / sub.NH : bh, hd = F3 ? bh - hb * sub.NH : 0;
  const int ld = F3 ? sub.NH * DH : DH;
  const int c0r = F3 ? c * sub.Lb : c * L;                 // the chunk's first row
  const int nv = F3 ? max(0, min(sub.Lb, S - c0r)) : L;  // its rows that hold data
  const size_t t0 = (size_t)hb * S + c0r;  // first row of the chunk
  const size_t slot = F3 ? ((size_t)hb * NC + c) * sub.NH + hd : (size_t)bh * NC + c;
  const int q0 = st * T_, l0 = 16 * warp;  // chunk row of the sub-tile, the warp's first row
  const bool active = l0 < T_;             // T_ is 16, 32 or 64: whole warps
  const float m_prev = EXP ? ms.m_states[slot] : 0.f;
  const T* qc = q + t0 * ld + hd * DH;
  const T* kc = k + t0 * ld + hd * DH;
  const T* vc = v + t0 * ld + hd * DH;
  const size_t grow = ((size_t)bh * NC + c) * L;  // F3: the chunk's gate rows

  auto prefetch = [&](int kt, int buf) {
    CT* dst = wk + 2 * buf * TR * LD;
    if constexpr (F3) {  // rows past the sub-chunk or S zero, with their gate rows
      const int r1 = min(kt * T_ + T_, nv);
      par::stage_tile<T, CT, DH, LD, TR, NTH>(dst, kc, kt * T_, r1, nullptr, 0.f, ld);
      par::stage_tile<T, CT, DH, LD, TR, NTH>(dst + TR * LD, vc, kt * T_, r1, nullptr, 0.f, ld);
      for (int r = threadIdx.x; r < T_; r += NTH) {
        tc::cp_async4(sgb + buf * TR + r, sub.b + grow + kt * T_ + r, true);
        tc::cp_async4(sgl + buf * TR + r, sub.li + grow + kt * T_ + r, true);
      }
    } else {  // whole tiles: with F3's runtime bound here, sub-tile-0 blocks went
              // wrong at 8+ chunks, DH 128, bf16 (cause not found; PERF.md §7)
      par::stage_tile<T, CT, DH, LD, TR, NTH>(dst, kc, kt * T_, kt * T_ + T_);
      par::stage_tile<T, CT, DH, LD, TR, NTH>(dst + TR * LD, vc, kt * T_, kt * T_ + T_);
    }
    tc::cp_async_commit();
  };
  if constexpr (F3) {
    for (int r = threadIdx.x; r < T_; r += NTH) tc::cp_async4(sob + r, sub.b + grow + q0 + r, true);
  } else {
    for (int r = threadIdx.x; r < L; r += NTH) {
      tc::cp_async4(rfg + r, fg + t0 + r, true);
      tc::cp_async4(rig + r, ig + t0 + r, true);
    }
  }
  for (int r = threadIdx.x; r < DH; r += NTH) tc::cp_async4(sn + r, n_states + slot * DH + r, true);
  if constexpr (F3) par::stage_tile<T, CT, DH, LD, TR, NTH>(sq, qc, q0, min(q0 + T_, nv), nullptr, 0.f, ld);
  else par::stage_tile<T, CT, DH, LD, TR, NTH>(sq, qc, q0, q0 + T_);
  par::stage_tile<StateT<CT, F3>, CT, DH, LD, DH, NTH>(sC, c_states + slot * DH * DH, 0, DH);
  tc::cp_async_commit();
  if constexpr (Tl::EARLY) {
    prefetch(0, 0);
    tc::cp_async_wait<1>();
  } else {
    tc::cp_async_wait<0>();
  }
  __syncthreads();
  if constexpr (!F3) {
    chunk_gates<EXP>(rig, rfg, L, sb, sli);
    __syncthreads();
  }

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float rb[2] = {0.f, 0.f}, rm[2] = {0.f, 0.f}, n_inter[2] = {0.f, 0.f};
  if (active) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int lr = l0 + g + 8 * hh, row = q0 + lr;  // the lane's row: in the tile, the chunk
      rb[hh] = F3 ? sob[lr] : sb[row];
      if constexpr (EXP) rm[hh] = row_mcomb(sb, sli, row, m_prev, t);
      const float qf = EXP ? expf((rb[hh] + m_prev) - rm[hh]) : expf(rb[hh]);
      float ni = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int cc = 8 * j + 2 * t;
        const float2 x = (!F3 || row < nv) ? tc::ld2(qc + (size_t)row * ld + cc)
                                           : make_float2(0.f, 0.f);
        const float a0 = (x.x * qf) * qk_scale, a1 = (x.y * qf) * qk_scale;
        tc::st2(sqb + lr * LD + cc, a0, a1);
        ni = fmaf(a0, sn[cc], ni);
        ni = fmaf(a1, sn[cc + 1], ni);
      }
      n_inter[hh] = tc::sum_over_cols(ni);
    }
    __syncwarp();  // the warp's R(qbar) rows are in
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)  // R(qbar) R(C_prev)
      tc::prod16<NJ, false, true>(acc, sqb, LD, l0, sC, LD, 0, 16 * kk);
  }
  if constexpr (!Tl::EARLY) {
    __syncthreads();  // the state's rows become the walk's buffers
    prefetch(0, 0);
  }

  float rsum[2] = {0.f, 0.f};
  par::walk_tiles(0, st, prefetch, [](int, int) {}, [&](int kt, int buf) {
    if (!active) return;
    const CT* ck = wk + 2 * buf * TR * LD;
    const int k0 = kt * T_;
    const float* tb = F3 ? sgb + buf * TR : sb + k0;   // the key tile's b
    const float* tl = F3 ? sgl + buf * TR : sli + k0;  // and logsig(i) (exp: i)
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      tc::prod16<NS, false, false>(s, sq, LD, l0, ck, LD, 0, 16 * kk);
    // sd = (s scale) D; the diagonal sub-tile masks j > l before the exp
    auto decay = [&](auto diag) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int j = 8 * n + 2 * t;
        const float2 bj = *reinterpret_cast<const float2*>(tb + j);
        const float2 lj = *reinterpret_cast<const float2*>(tl + j);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int hh = x >> 1, e = x & 1;
          float ex = (rb[hh] - (e ? bj.y : bj.x)) + (e ? lj.y : lj.x);
          if (EXP) ex -= rm[hh];
          if (decltype(diag)::value && j + e > l0 + g + 8 * hh) ex = -CUDART_INF_F;
          const float sd = (s[n][x] * qk_scale) * __expf(ex);
          rsum[hh] += sd;
          s[n][x] = sd;
        }
      }
    };
    if (kt == st) decay(std::true_type{});
    else decay(std::false_type{});
    par::score_times<NS, NJ>(acc, s, scratch, ck + TR * LD, LD);  // h += R(sd) R(v)
  });
  if (!active) return;

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float n_intra = tc::sum_over_cols(rsum[hh]);
    const float floor_ = EXP ? expf(-rm[hh]) : 1.f;
    const float den = fmaxf(fabsf(n_inter[hh] + n_intra), floor_);
    const int rr = q0 + l0 + g + 8 * hh;  // the lane's row of the chunk
    const size_t r = t0 + rr;
    if constexpr (F3) {
      if (rr >= sub.Lb) continue;  // padding past the sub-chunk
      if (t == 0 && sub.n_out) {
        const int cn = c / sub.NB, sub_c = c - cn * sub.NB;
        sub.n_out[(((size_t)hb * (NC / sub.NB) + cn) * sub.NH + hd) * sub.NB * sub.Lb +
                  sub_c * sub.Lb + rr] = den;
      }
      if (rr >= nv) continue;  // past S
    } else {
      if (t == 0 && den_out) den_out[r] = den;
      if (EXP && t == 0 && ms.mcomb_out) ms.mcomb_out[r] = rm[hh];
    }
    const float inv = den + eps;
    T* hr = h + r * ld + hd * DH;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      tc::st2(hr + 8 * j + 2 * t, acc[j][2 * hh] / inv, acc[j][2 * hh + 1] / inv);
  }
}

// The backward's dC scan, dC_{k-1} = gbar_k dC_k + R(qbar_k)^T R(dhn_k) from
// dC_last (or zeros), with qbar = (q qf) scale, qf = e^b (v1; gbar = e^g)
// or e^{(b + m_prev) - m_comb} (exp; m_prev and gbar from ms.mrow), and
// dhn = dh / (den + eps).  Every increment R(qbar_k)^T R(dhn_k) depends on
// chunk k alone, so the scan is two passes: dc_inc_kernel makes all of them
// at once on the tensor cores, writing chunk k's into the dC slot k - 1 (a
// chunk's into dc0), and dc_combine_kernel walks the chunks in reverse,
// a float32 scale-and-add of NC matrices an entry.
//
// The increment pass's tiling: a block of 4 warps per (TRW = min(DH, 64)
// rows i0.. of dC, chunk, batch * head), so that each dh tile is staged and
// divided by den + eps DH / TRW times in all (with 16 rows a block, as the
// forward's state pass, 8 times at DH 128 took 0.52 of a 0.54 ms call at
// (6656, 512), B 8, on an H100 at 700 W; PERF.md).  The warps split those rows in RG groups of 16 and the
// columns in CG groups of 8 NTW (DH 16: warps 0 and 1 hold 8 columns each,
// 2 and 3 only stage).  Shared memory: a tile's R(dhn) and raw q columns
// i0.., two deep, with dh's den rows; R(qbar) of those columns; the chunk's
// raw f, b, row factors and (exp) m_comb rows: 67.5 KB at DH 128 in bf16
// (three blocks an SM), 123.5 KB in float32.
template <typename T, typename CT, int DH>
struct IncTile {
  static constexpr int TRW = DH < TR ? DH : TR;  // rows of dC a block owns
  static constexpr int RG = TRW / 16;            // warps along those rows, 16 rows each
  static constexpr int CG = 4 / RG;              // and along the columns
  static constexpr int NTW = DH / 8 / CG > 0 ? DH / 8 / CG : 1;  // n-tiles of 8 columns a warp
  static constexpr int LDQ = TRW + tc::pad<CT>(), LDY = DH + tc::pad<CT>();
  static constexpr size_t bytes = sizeof(CT) * (2 * TR * LDY + TR * LDQ) +
                                  sizeof(T) * 2 * TR * TRW + 4 * (4 * LMAX + 2 * TR);
};
static_assert(IncTile<__nv_bfloat16, __nv_bfloat16, 128>::bytes <= 232448 / 3,
              "three blocks an SM");
static_assert(IncTile<float, float, 128>::bytes <= 232448, "a block's shared memory on Hopper");

// Chunk c's increment R(qbar_c)^T R(dhn_c), rows i0.. of it, into the dC
// slot c - 1 (c = 0: dc0); v1: also gbar_c = e^{g_c} into gbar (B * NH, NC),
// by the blocks of i0 = 0.  The chunk is read in tiles of T_ = min(L, 64)
// rows: the next tile's q columns and dh rows (and, with the first, the
// gates) load by cp.async while the current one is scaled, rounded and
// multiplied, 16 rows a step, into float32 accumulators: q's columns to
// R((q qf) scale), dh's rows to R(dh / (den + eps)), float32 division then
// round-to-nearest-even (in place when dh lands raw, T = CT; through
// registers otherwise).
template <typename T, typename CT, int DH, bool EXP>
__global__ void __launch_bounds__(par::NTC) dc_inc_kernel(
    const T* __restrict__ q, const T* __restrict__ dh, const float* __restrict__ fg,
    const float* __restrict__ den, float* __restrict__ dc_states, float* __restrict__ dc0,
    float* __restrict__ gbar, int S, int L, float qk_scale, float eps, MState ms) {
  using Tl = IncTile<T, CT, DH>;
  constexpr int TRW = Tl::TRW, NTW = Tl::NTW, LDQ = Tl::LDQ, LDY = Tl::LDY, NTH = par::NTC;
  constexpr int E = 16 / sizeof(T);                 // elements of a 16-byte copy
  constexpr bool RAW = std::is_same<T, CT>::value;  // dh staged unchanged, scaled in place
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CT* sy = reinterpret_cast<CT*>(smem_raw);      // 2 x (TR, LDY) R(dhn) of a tile
  CT* sqb = sy + 2 * TR * LDY;                   // (TR, LDQ) R(qbar), columns i0..
  T* rq = reinterpret_cast<T*>(sqb + TR * LDQ);  // 2 x (TR, TRW) q, columns i0..
  float* rfg = reinterpret_cast<float*>(rq + 2 * TR * TRW);  // (LMAX) f of the chunk
  float* sb = rfg + LMAX;     // (LMAX) b
  float* smc = sb + LMAX;     // (LMAX) exp: m_comb
  float* sfac = smc + LMAX;   // (LMAX) the row factor qf
  float* sden = sfac + LMAX;  // 2 x (TR) den of the staged dh rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * TRW, c = blockIdx.y, bh = blockIdx.z;
  const int NC = S / L, T_ = tile_rows(L), tiles = L / T_;
  const int m0 = 16 * (warp % Tl::RG);          // the warp's first row of dC, from i0
  const int nc0 = warp / Tl::RG * NTW * 8;      // and its first column
  const bool active = nc0 < DH;
  const size_t t0 = (size_t)bh * S + (size_t)c * L;  // first row of the chunk
  const size_t slot = (size_t)bh * NC + c;
  const T* qc = q + t0 * DH + i0;
  const T* dhc = dh + t0 * DH;
  const float* denc = den + t0;

  // tile tt into buffer buf
  auto prefetch = [&](int tt, int buf) {
    const int r0 = tt * T_;
    for (int e = tid; e < T_ * (TRW / E); e += NTH) {
      const int r = e / (TRW / E), cc = E * (e - r * (TRW / E));
      tc::cp_async16(rq + (buf * TR + r) * TRW + cc, qc + (size_t)(r0 + r) * DH + cc, true);
    }
    par::stage_tile<T, CT, DH, LDY, TR, NTH>(sy + buf * TR * LDY, dhc, r0, r0 + T_,
                                             RAW ? nullptr : denc, eps);
    if constexpr (RAW)
      for (int e = tid; e < TR; e += NTH)
        tc::cp_async4(sden + buf * TR + e, e < T_ ? denc + r0 + e : denc, e < T_);
    tc::cp_async_commit();
  };

  for (int r = tid; r < L; r += NTH) {
    tc::cp_async4(rfg + r, fg + t0 + r, true);
    if (EXP) tc::cp_async4(smc + r, ms.m_comb + t0 + r, true);
  }
  prefetch(0, 0);  // one group with the gates

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int col = tid % TRW;  // the q column this thread scales (NTH is a multiple of TRW)
  for (int tt = 0; tt < tiles; ++tt) {
    const int buf = tt & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile tt is in; every warp is done with the other buffer and R(qbar)
    if (tt + 1 < tiles) prefetch(tt + 1, buf ^ 1);
    if (tt == 0) {  // the chunk's b and row factors, while tile 1 loads
      chunk_gates<EXP>(nullptr, rfg, L, sb, nullptr);
      __syncthreads();
      const float m_prev = EXP ? ms.mrow[slot * 2] : 0.f;
      for (int r = tid; r < L; r += NTH)
        sfac[r] = EXP ? expf((sb[r] + m_prev) - smc[r]) : expf(sb[r]);
      if (!EXP && blockIdx.x == 0 && tid == 0) gbar[slot] = expf(sb[L - 1]);
      __syncthreads();
    }
    const T* cq = rq + buf * TR * TRW;
    for (int e = tid; e < T_ * TRW; e += NTH) {
      const int r = e / TRW;
      from_f32((to_f32(cq[e]) * sfac[tt * T_ + r]) * qk_scale, sqb + r * LDQ + col);
    }
    if constexpr (RAW) par::scale_rows<CT, DH, LDY, NTH>(sy + buf * TR * LDY, sden + buf * TR, eps);
    __syncthreads();
    if (active)
      for (int kk = 0; kk < T_ / 16; ++kk)  // R(qbar)^T R(dhn)
        tc::prod16<NTW, true, true>(acc, sqb, LDQ, m0, sy + buf * TR * LDY, LDY, nc0, 16 * kk);
  }
  if (!active) return;
  float* out = c == 0 ? dc0 + (size_t)bh * DH * DH : dc_states + (slot - 1) * DH * DH;
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      tc::st2(out + (size_t)(i0 + m0 + g + 8 * hh) * DH + nc0 + 8 * j + 2 * t, acc[j][2 * hh],
              acc[j][2 * hh + 1]);
}

// The combine pass over the increments dc_inc_kernel left: a thread owns 4
// entries of a head's dC and walks the chunks in reverse,
//   slot NC - 1 <- dC_last (or zeros),
//   slot k - 1  <- gbar_k slot k + slot k - 1   (k = NC - 1 .. 1),
//   dc0         <- gbar_0 slot 0 + dc0,
// the plain loop's float32 multiply, then add, each rounded (no FMA), in
// its order; gbar_k from gbar (B * NH, NC) (v1) or mrow's second column
// (exp, [m_prev, gbar] per chunk).  Grid (ceil(DH^2 / 4 / NT), B * NH).
template <bool EXP>
__global__ void __launch_bounds__(NT) dc_combine_kernel(
    const float* __restrict__ gbar, const float* __restrict__ dc_last, float* dc_states,
    float* dc0, int NC, int n) {
  const int e = 4 * (blockIdx.x * NT + threadIdx.x);
  if (e >= n) return;
  const size_t bh = blockIdx.y;
  float* const first = dc_states + bh * NC * n + e;  // dC after chunk 0
  float* const before = dc0 + bh * n + e;           // dC before chunk 0
  auto at = [&](int k) {  // where chunk k's increment lies, and dC before chunk k goes
    return reinterpret_cast<float4*>(k > 0 ? first + (size_t)(k - 1) * n : before);
  };
  float4 cur = dc_last ? *reinterpret_cast<const float4*>(dc_last + bh * n + e)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  *reinterpret_cast<float4*>(first + (size_t)(NC - 1) * n) = cur;
  float4 inc = *at(NC - 1);
  for (int k = NC - 1; k >= 0; --k) {
    const float gk = gbar[(bh * NC + k) * (EXP ? 2 : 1)];
    const float4 next = k > 0 ? *at(k - 1) : inc;  // the next increment's load flies
    cur.x = __fadd_rn(__fmul_rn(gk, cur.x), inc.x);
    cur.y = __fadd_rn(__fmul_rn(gk, cur.y), inc.y);
    cur.z = __fadd_rn(__fmul_rn(gk, cur.z), inc.z);
    cur.w = __fadd_rn(__fmul_rn(gk, cur.w), inc.w);
    *at(k) = cur;
    inc = next;
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

inline bool chunk_ok(int S, int L) {
  return L >= 16 && L <= LMAX && (L & (L - 1)) == 0 && S > 0 && S % L == 0;
}

// Launches the forward's two passes, fw_scan_kernel then fw_h_kernel, over
// B * NH heads of S rows in chunks of L; the CUDA error code.
template <typename T, typename CT, int DH, bool EXP>
int launch_fw(const T* q, const T* k, const T* v, const float* i, const float* f,
              const float* c0, const float* n0, T* h, float* den, float* c_states,
              float* n_states, float* c_last, float* n_last, int BNH, int S, int L,
              float qk_scale, float eps, MState ms, cudaStream_t st) {
  using Scan = ScanTile<T, CT, DH>;
  const size_t out_bytes = OutTile<CT, DH>::bytes;
  cudaError_t err = port::allow_smem(fw_scan_kernel<T, CT, DH, EXP>, Scan::bytes);
  if (err == cudaSuccess) err = port::allow_smem(fw_h_kernel<T, CT, DH, EXP>, out_bytes);
  if (err != cudaSuccess) return (int)err;
  fw_scan_kernel<T, CT, DH, EXP><<<dim3(BNH, DH / Scan::TRW), par::NTC, Scan::bytes, st>>>(
      k, v, i, f, c0, n0, c_states, n_states, c_last, n_last, S, L, ms, Sub{});
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fw_h_kernel<T, CT, DH, EXP><<<dim3(BNH, S / tile_rows(L)), par::NTC, out_bytes, st>>>(
      q, k, v, i, f, c_states, n_states, h, den, S, L, qk_scale, eps, ms, Sub{});
  return (int)cudaGetLastError();
}

// Launches the dC scan's two passes, dc_inc_kernel then dc_combine_kernel,
// over B * NH heads of S rows in chunks of L (v1: gbar a (B * NH, NC)
// scratch; exp: ms.mrow); the CUDA error code.
template <typename T, typename CT, int DH, bool EXP>
int launch_dc(const T* q, const T* dh, const float* f, const float* den, const float* dc_last,
              float* dc_states, float* dc0, float* gbar, int BNH, int S, int L, float qk_scale,
              float eps, MState ms, cudaStream_t st) {
  using Inc = IncTile<T, CT, DH>;
  cudaError_t err = port::allow_smem(dc_inc_kernel<T, CT, DH, EXP>, Inc::bytes);
  if (err != cudaSuccess) return (int)err;
  const int NC = S / L, n = DH * DH;
  dc_inc_kernel<T, CT, DH, EXP><<<dim3(DH / Inc::TRW, NC, BNH), par::NTC, Inc::bytes, st>>>(
      q, dh, f, den, dc_states, dc0, gbar, S, L, qk_scale, eps, ms);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dc_combine_kernel<EXP><<<dim3((n / 4 + NT - 1) / NT, BNH), NT, 0, st>>>(
      EXP ? ms.mrow + 1 : gbar, dc_last, dc_states, dc0, NC, n);
  return (int)cudaGetLastError();
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
