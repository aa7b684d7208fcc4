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
//
// Rounding points.  R(x) = rt<CT>(x) rounds x to the compute type CT and
// back where the TPU kernels cast the operands of a product; sums are
// float32.  The row sums of the denominator stay unrounded.
//
// Tiles.  A block of NT = 256 threads owns TR = 64 rows (queries in the
// forward and dQ, keys in dK/dV) and walks the 64-row tiles on the other
// side of the causal diagonal, one at a time through shared memory.  A
// (64 x 64) score tile is 16 x 16 threads of 4 x 4 register tiles
// (tile_dot); a row of the output is 4 threads of DH / 4 columns.  64 rows
// keep a block's shared memory near 43 KB (fw, dQ) or 67 KB (dK/dV) at
// DH = 32, so 3-5 blocks share an SM (114 KB and 162 KB at DH = 128: one), and give 96 * 104 = 9984 blocks at the longest
// sequence of the flagship (B 8, NH 12, S 6656), 75 waves over 132 SMs.
// The blocks with the longest walks are launched first (heavy_first), so
// that the causal triangle's short walks fill the tail.
#pragma once

#include <math_constants.h>

#include "common.cuh"

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

// Shared memory of a query-tile block (the forward, dQ): three (TR, DH + 1)
// operand tiles, a (TR, TP) score tile and three rows of TR; 42 KB at
// DH = 32, 66 KB at 64, 114 KB at 128 (dynamic).
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

}  // namespace par
