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
// Rounding points.  R(x) = rt<CT>(x) rounds x to the compute type CT and
// back where the TPU kernels cast the operands of a product; sums are
// float32.  The row sums of the denominator stay unrounded.
//
// Two designs share this file.
//
// The forward and dK/dV (tensor cores): a block owns 64 query rows (the
// forward, NTC = 128 threads) or 128 key rows (dK/dV with bf16 products),
// each warp 16 whole rows, and walks the 64-row tiles on the other side of
// the causal diagonal, staged in shared memory two deep (stage_tile: cp.async
// when the storage type is the compute type, else through registers,
// rounding on the way in).  The products are tc::prod16 (csrc/mma.cuh):
// mma.sync m16n8k16 with bf16 operands and float32 sums for CT = bf16, the
// same fragment layout as float32 FMA for CT = float.  A score fragment
// (the accumulator of a product) is scaled by D in registers, one exp per
// pair, and becomes the A operand of the next product (score_times): the
// accumulator layout of two 8-column n-tiles is the A layout of one
// 16-deep step, so in bf16 it never leaves the registers.
//
// dQ (float32 FMA on the CUDA cores): a block of NT = 256 threads owns 64
// query rows and walks the key tiles one at a time through shared memory.
// A (64 x 64) score tile is 16 x 16 threads of 4 x 4 register tiles
// (tile_dot); a row of the output is 4 threads of DH / 4 columns.
//
// Both launch the tiles with the longest walks first (heavy_first), so that
// the causal triangle's short walks fill the tail.
#pragma once

#include <math_constants.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace par {

using port::dispatch;
using port::from_f32;
using port::launch_with_smem;
using port::NT;
using port::rt;
using port::to_f32;

constexpr int TR = 64;      // rows of a tile
constexpr int TP = TR + 1;  // padded row of a (TR, TR) tile in shared memory

__host__ __device__ constexpr int tiles(int S) { return (S + TR - 1) / TR; }

// Shared memory of a dQ block: three (TR, DH + 1) operand tiles, a (TR,
// TP) score tile and three rows of TR; 42 KB at DH = 32, 66 KB at 64, 114
// KB at 128 (dynamic).
template <int DH>
constexpr size_t qtile_smem_floats() {
  return 3 * TR * (DH + 1) + TR * TP + 3 * TR;
}

// The tile of block index x when the tiles with the longest walks go first:
// query tiles walk the key tiles before them (long = late tile), key tiles
// the query tiles after them (long = early tile).
__device__ __forceinline__ int heavy_first(int x, int n, bool queries) {
  return queries ? n - 1 - x : x;
}

// dst[r * (DH + 1) + d] = R(x[r0 + r, d] / (den[r0 + r] + eps)) for the TR
// rows of a tile (den null: no division), zeros past S.
template <typename T, typename CT, int DH>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, const float* __restrict__ den,
                                          float eps, int r0, int S, float* dst) {
  constexpr int DP = DH + 1;
  for (int e = threadIdx.x; e < TR * DH; e += NT) {
    const int r = e / DH, d = e - r * DH;
    const int row = r0 + r;
    float val = 0.f;
    if (row < S) {
      val = to_f32(x[(size_t)row * DH + d]);
      if (den) val = val / (den[row] + eps);
    }
    dst[r * DP + d] = rt<CT>(val);
  }
}

// dst[r] = src[r0 + r] for the TR rows of a tile, zeros past S.
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int r0, int S,
                                          float* dst) {
  for (int r = threadIdx.x; r < TR; r += NT) dst[r] = r0 + r < S ? src[r0 + r] : 0.f;
}

// acc[r][s] = sum_d A[a_r, d] B[b_s, d] with a_r = 4 ti + r, b_s = 4 tj + s,
// for the (TR, DH + 1) tiles A and B in shared memory, d in order.
template <int DH>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm, int ti, int tj,
                                         float acc[4][4]) {
  constexpr int DP = DH + 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = A[(ti * 4 + r) * DP + d];
      b[r] = Bm[(tj * 4 + r) * DP + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
  }
}

// D[l, j] for query l and key j (absolute rows) from their gate rows: the
// exponent is masked before exp, and rows past S get 0.
__device__ __forceinline__ float decay(int l, int j, int S, float bl, float bj, float lij) {
  return (j <= l && l < S) ? expf((bl - bj) + lij) : 0.f;
}

// ---------------------------------------------------------------------------
// the tensor-core kernels (forward, dK/dV)
// ---------------------------------------------------------------------------

constexpr int NTC = 128;  // threads of a forward block: 4 warps of 16 rows

// The (ROWS, LD) tile dst[r * LD + c] = R(x[r0 + r, c]) of a (S, DH)
// stream, zeros past S, by the NTH threads of a block: cp.async when T is
// CT (the caller commits and waits), else through registers, rounded to CT
// on the way in.  With den (T not CT only): R(x / (den + eps)), float32
// division, then the rounding.
template <typename T, typename CT, int DH, int LD, int ROWS = TR, int NTH = NTC>
__device__ __forceinline__ void stage_tile(CT* dst, const T* __restrict__ x, int r0, int S,
                                           const float* __restrict__ den = nullptr,
                                           float eps = 0.f) {
  if constexpr (std::is_same<T, CT>::value) {
    constexpr int E = 16 / sizeof(T), CR = DH / E;  // elements a copy, copies a row
    for (int e = threadIdx.x; e < ROWS * CR; e += NTH) {
      const int r = e / CR, c = E * (e - r * CR);
      const bool ok = r0 + r < S;
      tc::cp_async16(dst + r * LD + c, ok ? x + (size_t)(r0 + r) * DH + c : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DH / 2; e += NTH) {
      const int r = e / (DH / 2), c = 2 * (e - r * (DH / 2));
      const int row = r0 + r;
      float2 val = make_float2(0.f, 0.f);
      if (row < S) {
        val = tc::ld2(x + (size_t)row * DH + c);
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

}  // namespace par
