// Backward of the ViLLayer training epilogue [per-head LayerNorm -> + skip * x
// -> proj_down] for Hopper, sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` of xlstm_yolo_tpu/ops/pallas/
// epilogue.py:70 (launched by `_epilogue_bwd_pallas` :165).  It computes what
// that kernel computes, for the forward of xlstm_yolo_tpu_torch/ops/
// epilogue.py (`epilogue_forward`), with rows m = (b, s) of M = B * S:
//
//   hhat = (h - mean_head) * rstd,  rstd = rsqrt(E_head[(h - mean)^2] + eps)
//   z    = T(T(hhat * (1 + ln_w) + ln_b) + T(T(skip) * x))   (T: compute dtype)
//   dz   = g Wd           (Wd = proj_down weight (D, H), rounded to T)
//   dx   = dz * skip,  dskip = sum_m dz * x,  dln_w = sum_m dz * hhat,
//   dln_b = sum_m dz,  dbd = sum_m g,  dWd = g^T z,
//   dh   = rstd * (dhhat - mean_head(dhhat) - hhat * mean_head(dhhat * hhat)),
//   dhhat = dz * (1 + ln_w).
//
// The variance is the centered E[(x - m)^2] (the raw-moment form cancels
// for large-mean rows and goes negative in float32).  Any S: the rows form
// one flat range M, the last tile is masked.
//
// Design.  Three grid launches on the caller's stream:
//  1. rows: one block of 256 threads per tile of R rows.  It stages h, x
//     and g in shared memory (float32), recomputes the LayerNorm and z,
//     stores z (compute dtype) for step 2, computes dz = g Wd with
//     gemm_rows (Wd read through the caches), writes dh and dx, and
//     writes per-tile column sums of dln_w, dln_b, dskip and dbd.  The
//     tile holds 4 R (3H + D + NH) bytes: R = 32 where that fits in a
//     block's 227 KB (H 384 and 512), R = 16 at H 768 (172 KB); the
//     wrapper chooses (ops/epilogue.py `tile_rows`);
//  2. dWd = g^T z over row ranges (wgrad_kernel), one partial per range;
//  3. reduce_kernel: the per-tile and per-range partials summed in a fixed
//     order: the parameter gradients are deterministic (no atomics).
// All arithmetic is float32 FMA on the CUDA cores.
//
// What bounds it.  At B = 8, S = 6400 (M = 51,200, H = 384, D = 192) the
// two products are 15 GFLOP and the function moves ~180 MB in bf16: on
// the tensor cores it would be bound by bytes (~0.05 ms).  This first
// version does its products in float32 on the CUDA cores (67 TFLOP/s at
// best), so it is bound by operations and far from the bound; tensor-core
// tiles are left to a later change (times in PERF.md).

#include "common.cuh"

namespace {

using namespace port;

template <typename T, int R>
__global__ void __launch_bounds__(NT) epilogue_rows_kernel(
    const T* __restrict__ h, const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const float* __restrict__ skip, const float* __restrict__ wd, T* __restrict__ dh,
    T* __restrict__ dx, T* __restrict__ z, float* __restrict__ part, int M, int H, int D,
    int NH, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* sh = smem;            // (R, H): h, then hhat
  float* sx = sh + R * H;      // (R, H): x
  float* sdz = sx + R * H;     // (R, H): dz
  float* sg = sdz + R * H;     // (R, D): g
  float* srstd = sg + R * D;   // (R, NH)
  const int tid = threadIdx.x;
  const int DH = H / NH;
  const int m0 = blockIdx.x * R;

  for (int e = tid; e < R * H; e += NT) {
    const int r = e / H, c = e - r * H;
    const bool ok = m0 + r < M;
    sh[e] = ok ? to_f32(h[(size_t)(m0 + r) * H + c]) : 0.f;
    sx[e] = ok ? to_f32(x[(size_t)(m0 + r) * H + c]) : 0.f;
  }
  for (int e = tid; e < R * D; e += NT) {
    const int r = e / D, c = e - r * D;
    sg[e] = m0 + r < M ? to_f32(g[(size_t)(m0 + r) * D + c]) : 0.f;
  }
  __syncthreads();

  // per-head LayerNorm statistics, hhat in place
  for (int p = tid; p < R * NH; p += NT) {
    const int r = p / NH, hd = p - r * NH;
    float* row = sh + r * H + hd * DH;
    float mean = 0.f;
    for (int c = 0; c < DH; ++c) mean += row[c];
    mean /= DH;
    float var = 0.f;
    for (int c = 0; c < DH; ++c) {
      const float d = row[c] - mean;
      var = fmaf(d, d, var);
    }
    const float rstd = rsqrtf(var / DH + eps);
    for (int c = 0; c < DH; ++c) row[c] = (row[c] - mean) * rstd;
    srstd[p] = rstd;
  }
  __syncthreads();

  // z in the compute dtype (input of dWd)
  for (int e = tid; e < R * H; e += NT) {
    const int r = e / H, c = e - r * H;
    if (m0 + r >= M) continue;
    const float y = rt<T>(fmaf(sh[e], 1.f + lnw[c], lnb[c]));
    from_f32(rt<T>(y + rt<T>(rt<T>(skip[c]) * sx[e])), z + (size_t)(m0 + r) * H + c);
  }

  // dz = g Wd
  gemm_rows<T, 4, R>(sg, D, wd, H, sdz, H, D, H);
  __syncthreads();

  // dx, and per-tile column sums (fixed row order)
  const size_t tile = blockIdx.x;
  const int width = 3 * H + D;
  for (int c = tid; c < H; c += NT) {
    float s_lnw = 0.f, s_lnb = 0.f, s_skip = 0.f;
    const float sk = skip[c];
    for (int r = 0; r < R; ++r) {
      const float d = sdz[r * H + c];
      s_lnw = fmaf(d, sh[r * H + c], s_lnw);
      s_lnb += d;
      s_skip = fmaf(d, sx[r * H + c], s_skip);
      if (m0 + r < M) from_f32(d * sk, dx + (size_t)(m0 + r) * H + c);
    }
    part[tile * width + c] = s_lnw;
    part[tile * width + H + c] = s_lnb;
    part[tile * width + 2 * H + c] = s_skip;
  }
  for (int c = tid; c < D; c += NT) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += sg[r * D + c];
    part[tile * width + 3 * H + c] = s;
  }

  // LayerNorm backward per (row, head)
  for (int p = tid; p < R * NH; p += NT) {
    const int r = p / NH, hd = p - r * NH;
    if (m0 + r >= M) continue;
    const float* hh = sh + r * H + hd * DH;
    const float* dd = sdz + r * H + hd * DH;
    const float* w = lnw + hd * DH;
    float mdh = 0.f, mdhh = 0.f;
    for (int c = 0; c < DH; ++c) {
      const float dhh = dd[c] * (1.f + w[c]);
      mdh += dhh;
      mdhh = fmaf(dhh, hh[c], mdhh);
    }
    mdh /= DH;
    mdhh /= DH;
    const float rstd = srstd[p];
    T* out = dh + (size_t)(m0 + r) * H + hd * DH;
    for (int c = 0; c < DH; ++c) {
      const float dhh = dd[c] * (1.f + w[c]);
      from_f32(rstd * (dhh - mdh - hh[c] * mdhh), out + c);
    }
  }
}

template <typename T, int R>
int run(const void* h, const void* x, const void* g, const float* lnw, const float* lnb,
        const float* skip, const float* wd, void* dh, void* dx, float* dvec, float* dwd,
        void* z, float* part_vec, float* part_w, int M, int H, int D, int NH, int splits,
        float eps, cudaStream_t st) {
  const int tiles = cdiv(M, R);
  const size_t smem = sizeof(float) * (3 * R * H + R * D + R * NH);
  cudaError_t err = allow_smem(epilogue_rows_kernel<T, R>, smem);
  if (err != cudaSuccess) return (int)err;
  epilogue_rows_kernel<T, R><<<tiles, NT, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(x), static_cast<const T*>(g), lnw, lnb,
      skip, wd, static_cast<T*>(dh), static_cast<T*>(dx), static_cast<T*>(z), part_vec, M, H,
      D, NH, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<cdiv(3 * H + D, 32), NT, 0, st>>>(part_vec, dvec, tiles, 3 * H + D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)launch_wgrad<T>(static_cast<const T*>(g), static_cast<const T*>(z), part_w, dwd,
                              M, D, H, splits, st);
}

template <typename T>
int run_rows(int rows, const void* h, const void* x, const void* g, const float* lnw,
             const float* lnb, const float* skip, const float* wd, void* dh, void* dx,
             float* dvec, float* dwd, void* z, float* part_vec, float* part_w, int M, int H,
             int D, int NH, int splits, float eps, cudaStream_t st) {
  if (rows == 32)
    return run<T, 32>(h, x, g, lnw, lnb, skip, wd, dh, dx, dvec, dwd, z, part_vec, part_w, M,
                      H, D, NH, splits, eps, st);
  if (rows == 16)
    return run<T, 16>(h, x, g, lnw, lnb, skip, wd, dh, dx, dvec, dwd, z, part_vec, part_w, M,
                      H, D, NH, splits, eps, st);
  return 1000;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rows: R, 16 or 32.  Outputs: dh, dx
// (M, H) in the dtype; dvec = [dln_w (H), dln_b (H), dskip (H), dbd (D)]
// and dwd (D, H) float32.  Scratch: z (M, H) in the dtype, part_vec
// (ceil(M / R), 3H + D) and part_w (splits, D, H) float32.  Returns a CUDA
// error code (0 = launched); 1000 for a dtype or R it does not take.
extern "C" int epilogue_bw(const void* h, const void* x, const void* g, const float* lnw,
                           const float* lnb, const float* skip, const float* wd, void* dh,
                           void* dx, float* dvec, float* dwd, void* z, float* part_vec,
                           float* part_w, int M, int H, int D, int NH, int splits, int rows,
                           int dtype, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_rows<float>(rows, h, x, g, lnw, lnb, skip, wd, dh, dx, dvec, dwd, z, part_vec,
                           part_w, M, H, D, NH, splits, eps, st);
  if (dtype == 1)
    return run_rows<__nv_bfloat16>(rows, h, x, g, lnw, lnb, skip, wd, dh, dx, dvec, dwd, z,
                                   part_vec, part_w, M, H, D, NH, splits, eps, st);
  return 1000;
}
