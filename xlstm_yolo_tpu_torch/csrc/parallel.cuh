// Shared pieces of the quadratic (parallel) sigmoid-input-gate mLSTM kernels
// for Hopper, sm_90a: parallel_fw.cu (h and den) and parallel_bw.cu (dQ, and
// dK with dV).
//
// Layout: q, k, v, h, dh and the gradients (B * NH, S, DH) in the storage
// type T (float32 or bfloat16); the gate rows b = inclusive cumsum of
// logsig(f) and li = logsig(i), and den, (B * NH, S) float32.  The wrapper
// computes b and li (ops/parallel.py), as the TPU entry does outside its
// kernels, so the kernels and their plain versions see the same rows.
//
//   D[l, j] = e^{(b_l - b_j) + li_j} for j <= l, else 0
//
// is formed from the cumsum difference, with the exponent masked before
// exp: above the diagonal b_l - b_j > 0 and a full exp overflows.  No
// running max is needed: on and below the diagonal the exponent is <= 0.
// D is not factored into e^{b_l} e^{-b_j}: with closed forget gates b
// spans hundreds within a tile and the factors overflow.
//
// Rounding points.  R(x) rounds x to the compute type CT where the TPU
// kernels cast the operands of a product (on the way into shared memory,
// or packing a fragment to bf16); sums are float32.  The row sums of the
// denominator stay unrounded.
//
// The three kernels share one design on the tensor cores: a block owns 64
// query rows (the forward and dQ, NTC = 128 threads) or 128 key rows (dK/dV
// with bf16 products), each warp 16 whole rows, and walks the 64-row tiles
// on the other side of the causal diagonal, staged in shared memory two
// deep (walk_tiles, stage_tile: cp.async when the storage type is the
// compute type, else through registers, rounding on the way in).  The
// products are tc::prod16 (csrc/mma.cuh): mma.sync m16n8k16 with bf16
// operands and float32 sums for CT = bf16, the same fragment layout as
// float32 FMA for CT = float.  A score fragment (the accumulator of a
// product) is scaled by D in registers, one exp per pair (decay_pairs), and
// becomes the A operand of the next product (score_times): the accumulator
// layout of two 8-column n-tiles is the A layout of one 16-deep step, so in
// bf16 it never leaves the registers.  dq_step and dkv_step are one tile of
// the dQ and the dK/dV walks; the chunkwise dq/dk/dv kernel
// (chunkwise_v1.cuh) walks a chunk's sub-tiles with the same two functions.
// The forward keeps its own loop: its exps also feed den's row sums, and
// through walk_tiles and decay_pairs it took 12-15 % longer at DH 128.
//
// All launch the tiles with the longest walks first (heavy_first), so that
// the causal triangle's short walks fill the tail.
#pragma once

#include <math_constants.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace par {

using port::dispatch;

constexpr int TR = 64;  // rows of a tile

__host__ __device__ constexpr int tiles(int S) { return (S + TR - 1) / TR; }

// The tile of block index x when the tiles with the longest walks go first:
// query tiles walk the key tiles before them (long = late tile), key tiles
// the query tiles after them (long = early tile).
__device__ __forceinline__ int heavy_first(int x, int n, bool queries) {
  return queries ? n - 1 - x : x;
}

constexpr int NTC = 128;  // threads of a forward or dQ block: 4 warps of 16 rows

// The (ROWS, LD) tile dst[r * LD + c] = R(x[r0 + r, c]) of a (S, DH)
// stream whose rows lie ld elements apart (DH unless given), zeros past S,
// by the NTH threads of a block: cp.async when T is CT (the caller commits
// and waits), else through registers, rounded to CT on the way in.  With
// den (T not CT only): R(x / (den + eps)), float32 division, then the
// rounding.
template <typename T, typename CT, int DH, int LD, int ROWS = TR, int NTH = NTC>
__device__ __forceinline__ void stage_tile(CT* dst, const T* __restrict__ x, int r0, int S,
                                           const float* __restrict__ den = nullptr,
                                           float eps = 0.f, int ld = DH) {
  if constexpr (std::is_same<T, CT>::value) {
    constexpr int E = 16 / sizeof(T), CR = DH / E;  // elements a copy, copies a row
    for (int e = threadIdx.x; e < ROWS * CR; e += NTH) {
      const int r = e / CR, c = E * (e - r * CR);
      const bool ok = r0 + r < S;
      tc::cp_async16(dst + r * LD + c, ok ? x + (size_t)(r0 + r) * ld + c : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DH / 2; e += NTH) {
      const int r = e / (DH / 2), c = 2 * (e - r * (DH / 2));
      const int row = r0 + r;
      float2 val = make_float2(0.f, 0.f);
      if (row < S) {
        val = tc::ld2(x + (size_t)row * ld + c);
        if (den) {
          const float dd = den[row] + eps;
          val.x /= dd;
          val.y /= dd;
        }
      }
      tc::st2(dst + r * LD + c, val.x, val.y);
    }
  }
}

// tile[r, c] = R(tile[r, c] / (den_rows[r] + eps)) in place, by the NTH
// threads of a block: a (TR, LD) dh tile that stage_tile copied unchanged
// (T is CT) becomes R(dhn).
template <typename CT, int DH, int LD, int NTH>
__device__ __forceinline__ void scale_rows(CT* tile, const float* den_rows, float eps) {
  for (int e = threadIdx.x; e < TR * DH / 2; e += NTH) {
    const int r = e / (DH / 2), c = 2 * (e - r * (DH / 2));
    const float dd = den_rows[r] + eps;
    const float2 x = tc::ld2(tile + r * LD + c);
    tc::st2(tile + r * LD + c, x.x / dd, x.y / dd);
  }
}

// acc[j] += R(s) B[.., 8 j..] for j < NJ: the warp's (16 x 8 NS) score
// fragment s (accumulator layout) as the A operand, rounded to bf16, times
// B stored (K, N) with row stride ldb, K = 8 NS.  The accumulator of
// n-tiles 2 kk and 2 kk + 1 is the A fragment of step kk, packed in
// registers.
template <int NS, int NJ>
__device__ __forceinline__ void score_times(float (&acc)[NJ][4], const float (&s)[NS][4],
                                            float* /*scratch*/, const tc::bf16* Bm, int ldb) {
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    const uint32_t a[4] = {tc::pack(s[2 * kk][0], s[2 * kk][1]),
                           tc::pack(s[2 * kk][2], s[2 * kk][3]),
                           tc::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           tc::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    tc::mma_row<NJ, true>(acc, a, Bm, ldb, 0, 16 * kk);
  }
}

// The same in float32: s goes through the warp's (16, 8 NS + 4) scratch
// rows in shared memory for the FMA product.
template <int NS, int NJ>
__device__ __forceinline__ void score_times(float (&acc)[NJ][4], const float (&s)[NS][4],
                                            float* scratch, const float* Bm, int ldb) {
  constexpr int LDS = 8 * NS + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();  // the last product's reads of the scratch are done
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      tc::st2(scratch + (g + 8 * hh) * LDS + 8 * n + 2 * t, s[n][2 * hh], s[n][2 * hh + 1]);
  __syncwarp();
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk)
    tc::prod16<NJ, false, true>(acc, scratch, LDS, 0, Bm, ldb, 0, 16 * kk);
}

// Floats of a warp's score scratch: none for bf16 products.
template <typename CT, int NS>
__host__ __device__ constexpr int scratch_floats() {
  return std::is_same<CT, float>::value ? 16 * (8 * NS + 4) : 0;
}

// Walks tiles first..last staged two deep, buffer (t - first) % 2 for tile
// t: the caller has issued prefetch(first, 0); prefetch(t, buf) issues tile
// t's copies into buffer buf and commits them.  Once tile t is in (every
// thread waited, the block synchronised, so every warp is also done with
// tile t - 1), ready(t, buf) runs (it synchronises the block itself if it
// writes the tile), then tile t + 1's copies start and step(t, buf) uses
// tile t while they fly.
template <typename Prefetch, typename Ready, typename Step>
__device__ __forceinline__ void walk_tiles(int first, int last, Prefetch prefetch, Ready ready,
                                           Step step) {
  for (int t = first; t <= last; ++t) {
    const int buf = (t - first) & 1;
    tc::cp_async_wait<0>();
    __syncthreads();
    ready(t, buf);
    if (t < last) prefetch(t + 1, buf ^ 1);
    step(t, buf);
  }
}

// f(n, x, e^{ex(hh, c)}) for each entry s[n][x] of a warp's (16 x 8 NS)
// fragment: the lane's row g + 8 hh (hh = x / 2) and the tile column c = 8 n
// + 2 t + x % 2.  ex gives the exponent of D, masked (-inf) where the pair
// is not causal, so the exp never sees an overflowing exponent.
template <int NS, typename Ex, typename F>
__device__ __forceinline__ void decay_pairs(Ex ex, F f) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) f(n, x, __expf(ex(x >> 1, 8 * n + 2 * t + (x & 1))));
}

// One key tile of a warp's dq walk: P = R(dhn) R(v)^T as a (16 x TR)
// fragment (the warp's rows l0.. of the staged R(dhn) tile sn, the key
// tile's R(v) cv), scaled by D (decay_pairs, ex(hh, key column)), then
// acc += R(P) R(k) (ck, ldmatrix .trans in bf16).
template <int DH, typename CT, typename Ex>
__device__ __forceinline__ void dq_step(float (&acc)[DH / 8][4], const CT* sn, int l0,
                                        const CT* ck, const CT* cv, int ld, float* scratch,
                                        Ex ex) {
  constexpr int NS = TR / 8;
  float p[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)  // dhn . v
    tc::prod16<NS, false, false>(p, sn, ld, l0, cv, ld, 0, 16 * kk);
  decay_pairs<NS>(ex, [&](int n, int x, float d) { p[n][x] *= d; });
  score_times<NS, DH / 8>(acc, p, scratch, ck, ld);
}

// One query tile of a warp's dk/dv walk (the warp's 16 keys at row j0 of the
// own R(k) and R(v) tiles sk, sv; the query tile's R(q) cq and R(dhn) cn),
// QW query columns a step, one step's fragments live at a time: S^T = R(k)
// R(q)^T and P^T = R(v) R(dhn)^T as (16 x QW) fragments share one exp a
// pair (ex(hh, query column)), S^T also scaled by qk_scale, then dv += R(S^T
// D) R(dhn) and dk += R(P^T D) R(q).  scratch: two of the warp's score
// scratches (float32 products).
template <int DH, int QW, typename CT, typename Ex>
__device__ __forceinline__ void dkv_step(float (&ak)[DH / 8][4], float (&av)[DH / 8][4],
                                         const CT* sk, const CT* sv, int j0, const CT* cq,
                                         const CT* cn, int ld, float* scratch, float qk_scale,
                                         Ex ex) {
  constexpr int NS = QW / 8;  // n-tiles of 8 queries in a score fragment
  constexpr int NJ = DH / 8;  // n-tiles of 8 columns of dk and dv
#pragma unroll 1  // one QW step's fragments live at a time (DH 128: registers)
  for (int qo = 0; qo < TR; qo += QW) {
    float st[NS][4], pt[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) st[n][x] = pt[n][x] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      tc::prod16<NS, false, false>(st, sk, ld, j0, cq, ld, qo, 16 * kk);  // k . q
      tc::prod16<NS, false, false>(pt, sv, ld, j0, cn, ld, qo, 16 * kk);  // v . dhn
    }
    decay_pairs<NS>([&](int hh, int c) { return ex(hh, qo + c); }, [&](int n, int x, float d) {
      st[n][x] = (st[n][x] * qk_scale) * d;
      pt[n][x] *= d;
    });
    score_times<NS, NJ>(av, st, scratch, cn + qo * ld, ld);  // dv += R(S D)^T R(dhn)
    score_times<NS, NJ>(ak, pt, scratch + scratch_floats<CT, NS>(), cq + qo * ld, ld);
  }
}

}  // namespace par
