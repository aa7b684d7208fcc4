// Weight gradients of the port's row kernels on the tensor cores (sm_90a):
// part[s] = X[rows of s]^T Y[rows of s] over row ranges s (split-K), one
// float32 partial per range, then reduce_kernel (common.cuh) sums the
// partials in a fixed order, so the gradients are the same from run to run
// (no atomics).  Used by the FFN backward (csrc/ffn_bw.cu: dWd = g^T act,
// dWgz = dgz^T xn) and the epilogue backward (csrc/epilogue_bw.cu: dWd =
// g^T z); the float32 overload of launch_wgrad_any takes wgrad_kernel
// (common.cuh), float32 FMA.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace port {

using tc::bf16;

constexpr int WB = 128;  // weight-gradient output tile (P and N)
constexpr int WK = 32;   // rows a stage
constexpr int LDW = WB + 8;

// part[(s * P + p) * N + n] = sum over rows m of range s of X[m, p] * Y[m, n]
// on the tensor cores.  Grid (ceil(P / 128), ceil(N / 128), ranges); warp w
// owns rows p 64 (w % 2).., columns n 32 (w / 2).. of the block's tile.
// P and N are multiples of 8; columns and rows past the ends load as 0.
__global__ void __launch_bounds__(NT) wgrad_tc_kernel(const bf16* __restrict__ X,
                                                      const bf16* __restrict__ Y,
                                                      float* __restrict__ part, int M, int P,
                                                      int N, int rps) {
  __shared__ __align__(16) bf16 sX[2][WK * LDW];
  __shared__ __align__(16) bf16 sY[2][WK * LDW];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wp = warp & 1, wn = warp >> 1;
  const int p0 = blockIdx.x * WB, n0 = blockIdx.y * WB;
  const int mb = blockIdx.z * rps, me = min(M, mb + rps);
  constexpr int CH = WB / 8;  // 16-byte copies a row

  auto stage = [&](int buf, int mm) {
    for (int e = tid; e < 2 * WK * CH; e += NT) {
      const bool isy = e >= WK * CH;
      const int f = isy ? e - WK * CH : e;
      const int r = f / CH, c = f - r * CH;
      const int m = mm + r, col = (isy ? n0 : p0) + 8 * c, lim = isy ? N : P;
      const bool ok = m < me && col < lim;
      const bf16* src = (isy ? Y : X) + (ok ? (size_t)m * lim + col : 0);
      tc::cp_async16((isy ? sY[buf] : sX[buf]) + r * LDW + 8 * c, src, ok);
    }
    tc::cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int steps = me > mb ? (me - mb + WK - 1) / WK : 0;
  if (steps > 0) stage(0, mb);
  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    if (it + 1 < steps) {
      stage(buf ^ 1, mb + (it + 1) * WK);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) tc::load_a_t(a[i], sX[buf], LDW, 64 * wp + 16 * i, 16 * kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tc::mma_row<4, true>(acc[i], a[i], sY[buf], LDW, 32 * wn, 16 * kk);
    }
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.z * P * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 64 * wp + 16 * i + gq + 8 * h;
        const int n = n0 + 32 * wn + 8 * j + 2 * tq;
        if (p < P && n < N)
          *reinterpret_cast<float2*>(out + (size_t)p * N + n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

cudaError_t launch_wgrad_tc(const bf16* X, const bf16* Y, float* part, float* out, int M, int P,
                            int N, int splits, cudaStream_t st) {
  const int rps = rows_per_split(M, splits);
  const int used = cdiv(M, rps);
  dim3 grid(cdiv(P, WB), cdiv(N, WB), used);
  wgrad_tc_kernel<<<grid, NT, 0, st>>>(X, Y, part, M, P, N, rps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_kernel<<<cdiv((long long)P * N, 32), NT, 0, st>>>(part, out, used, P * N);
  return cudaGetLastError();
}

cudaError_t launch_wgrad_any(const bf16* X, const bf16* Y, float* part, float* out, int M, int P,
                             int N, int splits, cudaStream_t st) {
  return launch_wgrad_tc(X, Y, part, out, M, P, N, splits, st);
}
cudaError_t launch_wgrad_any(const float* X, const float* Y, float* part, float* out, int M,
                             int P, int N, int splits, cudaStream_t st) {
  return launch_wgrad<float>(X, Y, part, out, M, P, N, splits, st);
}

}  // namespace port
