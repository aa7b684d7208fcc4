// Backward of the ViLLayer training FFN branch [RMSNorm -> gate/z dense ->
// silu(gate) * z -> proj_down] for Hopper, sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` of xlstm_yolo_tpu/ops/pallas/ffn.py:53
// (launched by `_ffn_bwd_pallas` :142).  It computes what that kernel
// computes, for the forward of xlstm_yolo_tpu_torch/ops/ffn.py
// (`ffn_forward`), rows m = (b, s) of M = B * S, widths D and U, weights in
// the port's layout (Wgz (2U, D), Wd (D, U)), T the compute dtype:
//
//   r = rsqrt(mean(x^2) + eps),  xhat = x * r,  xn = T(xhat * wn)
//   gate, z = gz[:, :U], gz[:, U:] (saved by the forward);  sig = sigmoid(gate)
//   sil = gate * sig,  act = T(T(sil) * z)
//   dact = g Wd,  dWd = g^T act,  dbd = sum_m g
//   dz = dact * sil,  dgate = dact * z * (sig + sil * (1 - sig))
//   dgz = [T(dgate) | T(dz)],  dbgz = [sum_m dgate | sum_m dz]
//   dxn = dgz Wgz,  dWgz = dgz^T xn
//   dwn = sum_m dxn * xhat,  dx = dxn * wn * r - x * (sum(dxn * wn * x) * r^3 / D)
//
// Any S: the rows form one flat range M, the last tile is masked.
//
// Design.  Four grid launches on the caller's stream:
//  1. rows: one block of 256 threads per tile of R rows stages x and g in
//     shared memory, recomputes the norm (xn stored in the compute dtype for
//     dWgz), dact = g Wd (gemm_rows), the gate backward (act and dgz stored
//     for the weight gradients; dgz kept in shared memory), dxn = dgz Wgz
//     (gemm_rows), the RMSNorm backward into dx, and per-tile column sums
//     of dwn, dbd and dbgz.  The tile holds 4 R (2D + 2U + 2) bytes: R = 32
//     where that fits in a block's 227 KB (D 192, U 512), R = 16 at the
//     wider layers (D 256, U 704: 123 KB; D 384, U 1024: 180 KB); the
//     wrapper chooses (ops/ffn.py `tile_rows`);
//  2.-3. dWd = g^T act and dWgz = dgz^T xn over row ranges (wgrad_kernel);
//  4. reduce_kernel for every partial: deterministic sums, no atomics.
// All arithmetic is float32 FMA on the CUDA cores.
//
// What bounds it.  At B = 8, S = 6400, D = 192, U = 512 the four products
// are 60 GFLOP against ~165 MB moved in bf16: on the tensor cores it would
// be bound by operations (0.06 ms at 989 TFLOP/s).  This first version runs
// them in float32 on the CUDA cores (67 TFLOP/s peak), far from that bound;
// a tensor-core redesign is left to a later change (times in PERF.md).

#include "common.cuh"

namespace {

using namespace port;

template <typename T, int R>
__global__ void __launch_bounds__(NT) ffn_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ gz, const T* __restrict__ g,
    const float* __restrict__ wn, const float* __restrict__ wgz, const float* __restrict__ wd,
    T* __restrict__ dx, T* __restrict__ xn, T* __restrict__ act, T* __restrict__ dgz,
    float* __restrict__ part, int M, int D, int U, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;            // (R, D): x
  float* sg = sx + R * D;      // (R, D): g, then dxn
  float* sd = sg + R * D;      // (R, 2U): dact in [:, :U], then dgz
  float* srr = sd + R * 2 * U; // (R): rsqrt(mean x^2 + eps)
  float* sdot = srr + R;       // (R): sum(dxn * wn * x)
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * R;
  const int W2 = 2 * U;

  for (int e = tid; e < R * D; e += NT) {
    const int r = e / D, c = e - r * D;
    const bool ok = m0 + r < M;
    sx[e] = ok ? to_f32(x[(size_t)(m0 + r) * D + c]) : 0.f;
    sg[e] = ok ? to_f32(g[(size_t)(m0 + r) * D + c]) : 0.f;
  }
  __syncthreads();

  for (int r = warp; r < R; r += NT / 32) {  // one warp per row
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s = fmaf(sx[r * D + c], sx[r * D + c], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) srr[r] = rsqrtf(s / D + eps);
  }
  __syncthreads();

  for (int e = tid; e < R * D; e += NT) {
    const int r = e / D, c = e - r * D;
    if (m0 + r < M) from_f32(sx[e] * srr[r] * wn[c], xn + (size_t)(m0 + r) * D + c);
  }

  // dact = g Wd into sd[:, :U]
  gemm_rows<T, 4, R>(sg, D, wd, U, sd, W2, D, U);
  __syncthreads();

  // gate backward, one column per thread over the rows (fixed order sums)
  const size_t tile = blockIdx.x;
  const int width = 2 * D + W2;  // [dwn (D), dbd (D), dbgz (2U)]
  for (int u = tid; u < U; u += NT) {
    float s_gate = 0.f, s_z = 0.f;
    for (int r = 0; r < R; ++r) {
      float gate = 0.f, zz = 0.f;
      const bool ok = m0 + r < M;
      if (ok) {
        gate = to_f32(gz[(size_t)(m0 + r) * W2 + u]);
        zz = to_f32(gz[(size_t)(m0 + r) * W2 + U + u]);
      }
      const float sig = 1.f / (1.f + expf(-gate));
      const float sil = gate * sig;
      const float da = sd[r * W2 + u];
      const float dz = da * sil;
      const float dgate = da * zz * (sig + sil * (1.f - sig));
      s_gate += dgate;
      s_z += dz;
      sd[r * W2 + u] = rt<T>(dgate);
      sd[r * W2 + U + u] = rt<T>(dz);
      if (ok) {
        const size_t o = (size_t)(m0 + r);
        from_f32(rt<T>(sil) * zz, act + o * U + u);
        from_f32(dgate, dgz + o * W2 + u);
        from_f32(dz, dgz + o * W2 + U + u);
      }
    }
    part[tile * width + 2 * D + u] = s_gate;
    part[tile * width + 2 * D + U + u] = s_z;
  }
  for (int c = tid; c < D; c += NT) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += sg[r * D + c];
    part[tile * width + D + c] = s;
  }
  __syncthreads();

  // dxn = dgz Wgz into sg
  gemm_rows<T, 2, R>(sd, W2, wgz, D, sg, D, W2, D);
  __syncthreads();

  for (int r = warp; r < R; r += NT / 32) {
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s = fmaf(sg[r * D + c] * wn[c], sx[r * D + c], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sdot[r] = s;
  }
  __syncthreads();

  for (int c = tid; c < D; c += NT) {
    float s_wn = 0.f;
    for (int r = 0; r < R; ++r) {
      const float rr = srr[r];
      const float dxn = sg[r * D + c];
      const float xv = sx[r * D + c];
      s_wn = fmaf(dxn, xv * rr, s_wn);
      if (m0 + r < M)
        from_f32(dxn * wn[c] * rr - xv * (sdot[r] * rr * rr * rr / D),
                 dx + (size_t)(m0 + r) * D + c);
    }
    part[tile * width + c] = s_wn;
  }
}

template <typename T, int R>
int run(const void* x, const void* gz, const void* g, const float* wn, const float* wgz,
        const float* wd, void* dx, float* dvec, float* dwgz, float* dwd, void* xn, void* act,
        void* dgz, float* part_vec, float* part_w, int M, int D, int U, int splits, float eps,
        cudaStream_t st) {
  const int tiles = cdiv(M, R);
  const size_t smem = sizeof(float) * (2 * R * D + 2 * R * U + 2 * R);
  cudaError_t err = allow_smem(ffn_rows_kernel<T, R>, smem);
  if (err != cudaSuccess) return (int)err;
  ffn_rows_kernel<T, R><<<tiles, NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gz), static_cast<const T*>(g), wn, wgz,
      wd, static_cast<T*>(dx), static_cast<T*>(xn), static_cast<T*>(act), static_cast<T*>(dgz),
      part_vec, M, D, U, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<cdiv(2 * D + 2 * U, 32), NT, 0, st>>>(part_vec, dvec, tiles, 2 * D + 2 * U);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dWd (D, U) = g^T act; dWgz (2U, D) = dgz^T xn
  err = launch_wgrad<T>(static_cast<const T*>(g), static_cast<const T*>(act), part_w, dwd, M,
                        D, U, splits, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad<T>(static_cast<const T*>(dgz), static_cast<const T*>(xn), part_w,
                              dwgz, M, 2 * U, D, splits, st);
}

template <typename T>
int run_rows(int rows, const void* x, const void* gz, const void* g, const float* wn,
             const float* wgz, const float* wd, void* dx, float* dvec, float* dwgz, float* dwd,
             void* xn, void* act, void* dgz, float* part_vec, float* part_w, int M, int D,
             int U, int splits, float eps, cudaStream_t st) {
  if (rows == 32)
    return run<T, 32>(x, gz, g, wn, wgz, wd, dx, dvec, dwgz, dwd, xn, act, dgz, part_vec,
                      part_w, M, D, U, splits, eps, st);
  if (rows == 16)
    return run<T, 16>(x, gz, g, wn, wgz, wd, dx, dvec, dwgz, dwd, xn, act, dgz, part_vec,
                      part_w, M, D, U, splits, eps, st);
  return 1000;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rows: R, 16 or 32.  Outputs: dx (M, D)
// in the dtype; dvec = [dwn (D), dbd (D), dbgz (2U)], dwgz (2U, D), dwd
// (D, U) float32.  Scratch: xn (M, D), act (M, U), dgz (M, 2U) in the dtype;
// part_vec (ceil(M / R), 2D + 2U) and part_w (splits, 2U, D) float32.
// Returns a CUDA error code (0 = launched); 1000 for a dtype or R it does
// not take.
extern "C" int ffn_bw(const void* x, const void* gz, const void* g, const float* wn,
                      const float* wgz, const float* wd, void* dx, float* dvec, float* dwgz,
                      float* dwd, void* xn, void* act, void* dgz, float* part_vec,
                      float* part_w, int M, int D, int U, int splits, int rows, int dtype,
                      float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_rows<float>(rows, x, gz, g, wn, wgz, wd, dx, dvec, dwgz, dwd, xn, act, dgz,
                           part_vec, part_w, M, D, U, splits, eps, st);
  if (dtype == 1)
    return run_rows<__nv_bfloat16>(rows, x, gz, g, wn, wgz, wd, dx, dvec, dwgz, dwd, xn, act,
                                   dgz, part_vec, part_w, M, D, U, splits, eps, st);
  return 1000;
}
