// Helpers shared by the backward kernels of the port (sm_90a).
//
// - dtype helpers: float32 or bfloat16 in device memory, float32 math;
//   rt<T>(x) rounds x to T and back, where the JAX package casts to the
//   compute dtype;
// - wgrad_kernel: weight gradients X^T Y over the rows of (M, P) and
//   (M, N) activations, split over row ranges, one partial per range;
// - reduce_kernel: sums the rows of a (rows, cols) partial array in a
//   fixed order, so that gradients are the same from run to run (no
//   atomics);
// - dispatch: the storage type, compute type and head dim of a launcher's
//   arguments as template parameters; allow_smem: a kernel's dynamic
//   shared memory above 48 KB.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace port {

constexpr int NT = 256;  // threads per block of every kernel here

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* y) { *y = __float2bfloat16(x); }

template <typename T> __device__ __forceinline__ float rt(float x);
template <> __device__ __forceinline__ float rt<float>(float x) { return x; }
template <> __device__ __forceinline__ float rt<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// part[(s * P + p) * N + n] = sum over rows m of range s of X[m, p] * Y[m, n].
// Grid (ceil(P / 64), ceil(N / 64), splits); a block owns a 64 x 64 tile,
// a thread a 4 x 4 piece of it; rows are staged 32 at a time.
template <typename T>
__global__ void __launch_bounds__(NT) wgrad_kernel(const T* __restrict__ X,
                                                   const T* __restrict__ Y,
                                                   float* __restrict__ part, int M, int P,
                                                   int N, int rows_per_split) {
  __shared__ float sX[32][64 + 4];
  __shared__ float sY[32][64 + 4];
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * 64, n0 = blockIdx.y * 64, s = blockIdx.z;
  const int m0 = s * rows_per_split;
  const int m1 = min(M, m0 + rows_per_split);
  const int tp = tid / 16, tn = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int mm = m0; mm < m1; mm += 32) {
    for (int e = tid; e < 32 * 64; e += NT) {
      const int r = e / 64, c = e % 64;
      const int m = mm + r;
      sX[r][c] = (m < m1 && p0 + c < P) ? to_f32(X[(size_t)m * P + p0 + c]) : 0.f;
      sY[r][c] = (m < m1 && n0 + c < N) ? to_f32(Y[(size_t)m * N + n0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sX[r][tp * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sY[r][tn * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + tp * 4 + i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < N) part[((size_t)s * P + p) * N + n] = acc[i][j];
    }
  }
}

// out[c] = sum_{t < rows} part[t * cols + c], summed in a fixed order.
// Grid ceil(cols / 32); 8 lanes of 32 columns, each lane a strided
// sequential sum, then the 8 lanes in order.
__global__ void __launch_bounds__(NT) reduce_kernel(const float* __restrict__ part,
                                                    float* __restrict__ out, int rows, int cols) {
  __shared__ float s[8][33];
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  const int lane = threadIdx.x >> 5;
  float acc = 0.f;
  if (c < cols)
    for (int t = lane; t < rows; t += 8) acc += part[(size_t)t * cols + c];
  s[lane][threadIdx.x & 31] = acc;
  __syncthreads();
  if (lane == 0 && c < cols) {
    float r = 0.f;
#pragma unroll
    for (int l = 0; l < 8; ++l) r += s[l][threadIdx.x & 31];
    out[c] = r;
  }
}

inline int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// Splits of the rows for wgrad_kernel: enough blocks to fill the card.
inline int rows_per_split(int M, int splits) { return 32 * cdiv(cdiv(M, splits), 32); }

template <typename T>
cudaError_t launch_wgrad(const T* X, const T* Y, float* part, float* out, int M, int P, int N,
                         int splits, cudaStream_t st) {
  const int rps = rows_per_split(M, splits);
  const int used = cdiv(M, rps);
  dim3 grid(cdiv(P, 64), cdiv(N, 64), used);
  wgrad_kernel<T><<<grid, NT, 0, st>>>(X, Y, part, M, P, N, rps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_kernel<<<cdiv((long long)P * N, 32), NT, 0, st>>>(part, out, used, P * N);
  return cudaGetLastError();
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB a
// kernel must ask for it before its launch).
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Launches kernel<<<grid, NT, smem, st>>>(args...) after allow_smem; the
// CUDA error code of the launch.
template <typename K, typename... A>
int launch_with_smem(K* kernel, dim3 grid, size_t smem, cudaStream_t st, A... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// The head dims every mLSTM kernel takes (HEAD_DIMS in ops/cuda_build.py).
template <typename T, typename CT, typename F>
int dispatch_dh(int DH, F&& f) {
  switch (DH) {
    case 16: return f(T{}, CT{}, std::integral_constant<int, 16>{});
    case 32: return f(T{}, CT{}, std::integral_constant<int, 32>{});
    case 64: return f(T{}, CT{}, std::integral_constant<int, 64>{});
    case 128: return f(T{}, CT{}, std::integral_constant<int, 128>{});
    default: return 1000;
  }
}

// Calls f(T{}, CT{}, std::integral_constant<int, DH>{}) for the storage
// type (0 float32, 1 bfloat16), the compute type (same codes) and the head
// dim (16, 32, 64 or 128); 1000 for a combination the kernels do not take.
template <typename F>
int dispatch(int dtype, int cdtype, int DH, F&& f) {
  using bf16 = __nv_bfloat16;
  switch (dtype * 10 + cdtype) {
    case 0: return dispatch_dh<float, float>(DH, f);
    case 1: return dispatch_dh<float, bf16>(DH, f);
    case 10: return dispatch_dh<bf16, float>(DH, f);
    case 11: return dispatch_dh<bf16, bf16>(DH, f);
    default: return 1000;
  }
}

}  // namespace port
