// Shared pieces of the v1 chunkwise mLSTM kernels (chunkwise_v1_fw.cu,
// chunkwise_v1_bw.cu), sm_90a.
//
// Layout: q, k, v, h, dh (B * NH, S, DH) in the storage type T (float32 or
// bfloat16); gates i, f and the denominator den (B * NH, S) float32; states
// (B * NH, NC, DH, DH) float32.  S is a multiple of the chunk length L.
//
// Rounding points.  The JAX kernels cast the operands of every product to
// their compute dtype and sum in float32; rt<CT>(x) rounds x to the compute
// type CT and back, at the same operands.  Row sums (the denominator, n)
// stay unrounded.
//
// - chunk_gates: the gate rows of one chunk in shared memory, b = inclusive
//   cumsum of logsig(f) over the chunk and logsig(i);
// - state_scan_kernel: the serial pass over the chunks of one (batch, head)
//   that carries a DH x DH state (the forward's C and n, or the backward's
//   dC), one block each.
#pragma once

#include <math_constants.h>
#include <type_traits>

#include "common.cuh"

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

// sb[r] = sum_{t <= r} logsig(f[t]) and, if ig, sli[r] = logsig(i[r]) for
// the L rows of one chunk (gates at fg, ig).  Warp 0 works: each lane sums
// its run of ceil(L / 32) rows, then a shuffle scan adds the runs before
// it.  The caller synchronises the block.
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
    if (ig) sli[r] = log_sigmoid(ig[r]);
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

// One block per (batch, head) walks its chunks, forward (BW = false) or in
// reverse (BW = true), carrying a DH x DH state in registers: thread t owns
// row t / (DH / EPT) and EPT consecutive columns.
//
//   forward:  stores C, n before chunk c into states / n_states, then
//             C <- e^g C + R(k e^a)^T R(v),  n <- e^g n + sum_l k_l e^{a_l};
//             x = k, y = v, s0 = c0, n0;  s_last = C, n_last = n after the last chunk
//   backward: stores dC after chunk c into states, then
//             dC <- e^g dC + R(q e^b scale)^T R(dh / (den + eps));
//             x = q, y = dh, s0 = dC_last;  s_last = dC0
//
// with a = (g - b) + logsig(i) and g = b[L - 1].  A chunk is read in tiles
// of TR rows staged in shared memory.
template <typename T, typename CT, int DH, bool BW>
__global__ void __launch_bounds__(NT) state_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const float* __restrict__ ig,
    const float* __restrict__ fg, const float* __restrict__ den, const float* __restrict__ s0,
    const float* __restrict__ n0, float* __restrict__ states, float* __restrict__ n_states,
    float* __restrict__ s_last, float* __restrict__ n_last, int S, int L, float qk_scale,
    float eps) {
  static_assert(DH == 16 || DH == 32, "head dim 16 or 32");
  constexpr int EPT = DH * DH / NT;  // state entries per thread
  constexpr int TPR = DH / EPT;      // threads per state row
  constexpr int DP = DH + 1;
  __shared__ float sb[LMAX], sli[LMAX];
  __shared__ float sfac[LMAX];   // the row factor: e^a (forward), e^b (backward)
  __shared__ float sa[TR * DP];  // R(x * row factor)
  __shared__ float sy[TR * DP];  // R(y), divided by den + eps in the backward

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

  for (int it = 0; it < NC; ++it) {
    const int c = BW ? NC - 1 - it : it;
    const size_t t0 = rows0 + (size_t)c * L;
    const size_t slot = (size_t)bh * NC + c;
#pragma unroll
    for (int e = 0; e < EPT; ++e) states[slot * DH * DH + dr * DH + dc0 + e] = st[e];
    if (!BW && tid < DH) n_states[slot * DH + tid] = nst;

    chunk_gates(BW ? nullptr : ig + t0, fg + t0, L, sb, sli);
    __syncthreads();
    const float g = sb[L - 1];
    for (int r = tid; r < L; r += NT) sfac[r] = BW ? expf(sb[r]) : expf((g - sb[r]) + sli[r]);
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
    const float eg = expf(g);
#pragma unroll
    for (int e = 0; e < EPT; ++e) st[e] = fmaf(eg, st[e], acc[e]);
    if (!BW && tid < DH) nst = fmaf(eg, nst, nacc);
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e) s_last[(size_t)bh * DH * DH + dr * DH + dc0 + e] = st[e];
  if (!BW && tid < DH) n_last[(size_t)bh * DH + tid] = nst;
}

// Calls f(T{}, CT{}, std::integral_constant<int, DH>{}) for the storage
// type (0 float32, 1 bfloat16), the compute type (same codes) and the head
// dim; 1000 for a combination the kernels do not take.
template <typename F>
int dispatch(int dtype, int cdtype, int DH, F&& f) {
  using D16 = std::integral_constant<int, 16>;
  using D32 = std::integral_constant<int, 32>;
  using bf16 = __nv_bfloat16;
  const int key = dtype * 100 + cdtype * 10 + (DH == 32 ? 1 : DH == 16 ? 0 : 9);
  switch (key) {
    case 0: return f(float{}, float{}, D16{});
    case 1: return f(float{}, float{}, D32{});
    case 10: return f(float{}, bf16{}, D16{});
    case 11: return f(float{}, bf16{}, D32{});
    case 100: return f(bf16{}, float{}, D16{});
    case 101: return f(bf16{}, float{}, D32{});
    case 110: return f(bf16{}, bf16{}, D16{});
    case 111: return f(bf16{}, bf16{}, D32{});
    default: return 1000;
  }
}

inline bool chunk_ok(int S, int L) {
  return L >= 16 && L <= LMAX && (L & (L - 1)) == 0 && S > 0 && S % L == 0;
}

}  // namespace v1
