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
// What bounds it.  It reads and writes C (64 KB a head at DH = 128) and n
// and reads q, k, v: 6.3 MB at vil-det-384's B 8, NH 6, 1.9 us at 3.35
// TB/s, 0.8 MB at the flagship's B 8, NH 12, DH 32; 4 DH^2 flop a head.
// So bytes, and at DH = 32 the launch.
//
// Design.  A block of 128 threads per (batch * head, slab of W = min(32, DH)
// columns of C): B NH DH / W blocks.  Each thread owns four columns (one
// float4) of DH / (128 / (W / 4)) rows of the slab; it issues all its
// loads of C before their first use, updates them in registers, writes
// c_new as float4 and keeps the four column sums of qs[d] C'[d, col].  The
// lanes of a column are summed by shuffles, the four warps in shared memory
// once, in a fixed order.  The first warp computes qs . n' (DH floats, one
// shuffle reduction) while the others update C; the first slab's block
// writes n'.  No dynamic shared memory, so no attribute is set a launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "common.cuh"

using namespace port;

namespace {

constexpr int STEP_NT = 128;
constexpr int STEP_WARPS = STEP_NT / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T, int DH>
__global__ void __launch_bounds__(STEP_NT) step_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg, const float* __restrict__ c,
    const float* __restrict__ n, T* __restrict__ h, float* __restrict__ c_new,
    float* __restrict__ n_new, float qk_scale, float eps) {
  constexpr int W = DH < 32 ? DH : 32;              // columns of a slab
  constexpr int QPR = W / 4;                        // float4 quads of a slab's row
  constexpr int RPP = STEP_NT / QPR;                // rows a pass of the block
  constexpr int PASSES = (DH + RPP - 1) / RPP;      // rows a thread
  constexpr int ND = (DH + 31) / 32;                // n' entries a lane
  __shared__ float4 part[STEP_WARPS][QPR];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = blockIdx.x;
  const int quad = tid % QPR, r0 = tid / QPR;
  const int col = blockIdx.y * W + 4 * quad;
  const float* cb = c + bh * DH * DH + col;

  float4 cv[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int r = r0 + p * RPP;
    if (r < DH) cv[p] = __ldg(reinterpret_cast<const float4*>(cb + (size_t)r * DH));
  }
  const float i_gate = sigmoid(ig[bh]);
  const float f_gate = sigmoid(fg[bh]);
  const T* qb = q + bh * DH;
  const T* kb = k + bh * DH;
  float kr[PASSES], qr[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int r = r0 + p * RPP;
    kr[p] = r < DH ? i_gate * to_f32(kb[r]) : 0.f;  // ig k[r]
    qr[p] = r < DH ? to_f32(qb[r]) * qk_scale : 0.f;
  }
  float vv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) vv[j] = to_f32(v[bh * DH + col + j]);

  // den = max(|qs . n'|, 1) + eps in the first warp, which writes h; the
  // first slab's block writes n'
  float den = 0.f;
  if (warp == 0) {
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = lane + 32 * j;
      if (d < DH) {
        const float nn = f_gate * n[bh * DH + d] + i_gate * to_f32(kb[d]);
        if (blockIdx.y == 0) n_new[bh * DH + d] = nn;
        dot = fmaf(to_f32(qb[d]) * qk_scale, nn, dot);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
    den = fmaxf(fabsf(dot), 1.f) + eps;
  }

  float num[4] = {0.f, 0.f, 0.f, 0.f};
  float* cn = c_new + bh * DH * DH + col;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int r = r0 + p * RPP;
    if (r < DH) {
      float4 x;
      x.x = f_gate * cv[p].x + kr[p] * vv[0];
      x.y = f_gate * cv[p].y + kr[p] * vv[1];
      x.z = f_gate * cv[p].z + kr[p] * vv[2];
      x.w = f_gate * cv[p].w + kr[p] * vv[3];
      *reinterpret_cast<float4*>(cn + (size_t)r * DH) = x;
      num[0] = fmaf(qr[p], x.x, num[0]);
      num[1] = fmaf(qr[p], x.y, num[1]);
      num[2] = fmaf(qr[p], x.z, num[2]);
      num[3] = fmaf(qr[p], x.w, num[3]);
    }
  }
  // the lanes of a quad (lane % QPR) hold other rows of the same columns
#pragma unroll
  for (int o = QPR; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) num[j] += __shfl_xor_sync(FULL, num[j], o);
  if (lane < QPR) part[warp][lane] = make_float4(num[0], num[1], num[2], num[3]);
  __syncthreads();
  if (tid < W) {
    const float* pw = reinterpret_cast<const float*>(&part[0][0]);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < STEP_WARPS; ++w) s += pw[w * W + tid];
    from_f32(s / den, h + bh * DH + blockIdx.y * W + tid);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, h).  i, f (B * NH) float32
// pre-activations; c (B * NH, DH, DH), n (B * NH, DH) float32 in, c_new,
// n_new out (distinct buffers); every pointer 16-byte aligned.  Returns a
// CUDA error code; 1000 for a dtype or head size the kernel does not take.
extern "C" int mlstm_step(const void* q, const void* k, const void* v, const float* i,
                          const float* f, const float* c, const float* n, void* h, float* c_new,
                          float* n_new, int BNH, int DH, int dtype, float qk_scale, float eps,
                          void* stream) {
  if (BNH <= 0) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, dtype, DH, [&](auto t, auto, auto dh) -> int {
    using T = decltype(t);
    constexpr int D = decltype(dh)::value;
    constexpr int W = D < 32 ? D : 32;
    step_kernel<T, D><<<dim3(BNH, D / W), STEP_NT, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), i, f, c,
        n, static_cast<T*>(h), c_new, n_new, qk_scale, eps);
    return (int)cudaGetLastError();
  });
}
