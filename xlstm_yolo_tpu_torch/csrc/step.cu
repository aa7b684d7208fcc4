// One-token sigmoid-input-gate mLSTM step for Hopper, sm_90a.
//
// Replaces the TPU kernel `_step_kernel` (xlstm_yolo_tpu/ops/pallas/
// step.py:31, launched by `mlstm_siging_step_pallas` :53, call :74).  Per
// (batch * head), with ig = sigmoid(i), fg = sigmoid(f), qs = q scale:
//
//   C' = fg C + ig (k v^T),   n' = fg n + ig k
//   h  = (qs C') / (max(|qs . n'|, 1) + eps)
//
// C, n and their updates float32; q, k, v and h in the storage type (float32
// or bfloat16); all arithmetic float32, sums in a fixed order.
//
// Design.  One block of 256 threads per (batch, head): the DH x DH update
// is spread over the block (4 entries a thread at DH = 32) and staged in
// shared memory, where DH threads take the column sums of qs C' and one
// warp the dot product qs . n'.
//
// What bounds it.  It reads and writes C (4 KB a head at DH = 32) and n and
// reads q, k, v: 0.8 MB at the flagship's B 8, NH 12, 0.24 us at 3.35 TB/s,
// and 4 DH^2 flop a head.  At that size one launch costs more than the
// work, so launch latency sets its time (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "common.cuh"

using namespace port;

template <typename T, int DH>
__global__ void __launch_bounds__(NT) step_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg, const float* __restrict__ c,
    const float* __restrict__ n, T* __restrict__ h, float* __restrict__ c_new,
    float* __restrict__ n_new, float qk_scale, float eps) {
  constexpr int DP = DH + 1;
  __shared__ float sq[DH], sk[DH], sv[DH], sn[DH], sC[DH * DP];
  __shared__ float sden;
  const int tid = threadIdx.x;
  const size_t bh = blockIdx.x;
  const float i_gate = 1.f / (1.f + expf(-ig[bh]));
  const float f_gate = 1.f / (1.f + expf(-fg[bh]));
  if (tid < DH) {
    sq[tid] = to_f32(q[bh * DH + tid]) * qk_scale;
    sk[tid] = to_f32(k[bh * DH + tid]);
    sv[tid] = to_f32(v[bh * DH + tid]);
  }
  __syncthreads();
  for (int e = tid; e < DH * DH; e += NT) {
    const int d = e / DH, col = e - d * DH;
    const float x = f_gate * c[bh * DH * DH + e] + i_gate * (sk[d] * sv[col]);
    c_new[bh * DH * DH + e] = x;
    sC[d * DP + col] = x;
  }
  if (tid < DH) {
    const float x = f_gate * n[bh * DH + tid] + i_gate * sk[tid];
    n_new[bh * DH + tid] = x;
    sn[tid] = x;
  }
  __syncthreads();
  if (tid < 32) {  // den = max(|qs . n'|, 1)
    float p = 0.f;
    for (int d = tid; d < DH; d += 32) p = fmaf(sq[d], sn[d], p);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (tid == 0) sden = fmaxf(fabsf(p), 1.f);
  }
  __syncthreads();
  if (tid < DH) {
    float num = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) num = fmaf(sq[d], sC[d * DP + tid], num);
    from_f32(num / (sden + eps), h + bh * DH + tid);
  }
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, h).  i, f (B * NH) float32
// pre-activations; c (B * NH, DH, DH), n (B * NH, DH) float32 in, c_new,
// n_new out (distinct buffers).  Returns a CUDA error code; 1000 for a dtype
// or head size the kernel does not take.
extern "C" int mlstm_step(const void* q, const void* k, const void* v, const float* i,
                          const float* f, const float* c, const float* n, void* h, float* c_new,
                          float* n_new, int BNH, int DH, int dtype, float qk_scale, float eps,
                          void* stream) {
  if (BNH <= 0) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, dtype, DH, [&](auto t, auto, auto dh) -> int {
    using T = decltype(t);
    constexpr int D = decltype(dh)::value;
    step_kernel<T, D><<<BNH, NT, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), i, f, c,
        n, static_cast<T*>(h), c_new, n_new, qk_scale, eps);
    return (int)cudaGetLastError();
  });
}
