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
// The Pallas kernel rounds every product's operands to T and sums in
// float32 (preferred_element_type=f32), so with T = bfloat16 the four
// products are bf16 tensor-core products with float32 sums.  Any S: the
// rows form one flat range M, the last tile is masked.
//
// What bounds it.  At B = 8, S = 6400, D = 384, U = 1024 the four products
// are 241 GFLOP against ~0.5 GB moved in bf16: bound by operations, 0.24 ms
// at 989 TFLOP/s (D = 192, U = 512: 60 GFLOP, 0.06 ms).
//
// Design.  Four steps on the caller's stream:
//  1. rows (ffn_rows_kernel): one block of 8 warps per tile of 64 rows.  g
//     is staged in shared memory with cp.async; x is read from device
//     memory for the norm (xn stored in T) and again in the norm backward.
//     A 64-row tile of dgz alone is 256 KB at U 1024, more than a block's
//     227 KB, so the two row products run back to back over blocks of UB
//     columns of U: dact for the block (g Wd[:, ub]), the gate backward on
//     its accumulators (act and dgz stored in T, dgz also into shared
//     memory, per-tile column sums of dgate and dz), then dxn += dgz_blk
//     Wgz[ub rows].  dxn (64 x D, float32) stays in registers across the
//     blocks, each warp holding 16 rows and half of D (96 registers at D
//     384).  Then the RMSNorm backward from the registers into dx and
//     per-tile column sums of dwn and dbd.
//  2.-3. dWd = g^T act and dWgz = dgz^T xn over row ranges (split-K), one
//     float32 partial per range;
//  4. reduce_kernel for every partial: sums in a fixed order, no atomics.
// bfloat16: the products run on the tensor cores as warp-level mma.sync
// m16n8k16 (csrc/mma.cuh), chosen over wgmma because its fragments need no
// shared-memory descriptors or swizzled layouts and are fixed by the PTX
// ISA, so the first tensor-core version is simple to get right; wgmma is
// the next step.  UB = 32, and the next block's weights (Wd[:, ub], Wgz's
// 64 rows, cast to bf16 once per call by the wrapper) load with cp.async
// into a second buffer while this block computes: 229 KB of shared memory
// at D 384, one block an SM.  The weight gradients are 128 x 128 output
// tiles of 8 warps, 32 rows a stage in a cp.async double buffer
// (wgrad_tc_kernel), with enough row ranges for two waves of the card's
// 132 SMs.
// float32: the same row pass with float32 products as FMA on the CUDA
// cores, each thread summing over k in order the outputs an mma fragment
// would hold; UB = 16 and one weight buffer (float32 tiles are twice the
// size: 192 KB at D 384); the weight gradients by wgrad_kernel
// (common.cuh).  It serves the float32 checks; training runs bf16.
// The wrapper takes D in {32, 192, 256, 384} (every detector's width) and U
// a multiple of 32, and raises on others.

#include "common.cuh"
#include "mma.cuh"
#include "wgrad.cuh"

namespace {

using namespace port;
using tc::bf16;

constexpr int TR = 64;  // rows of a tile of the row pass

template <typename T> struct RowCfg;
template <> struct RowCfg<bf16> {  // tensor cores
  static constexpr int UB = 32, STAGES = 2, PAD = 8;  // PAD: ldmatrix bank groups
};
template <> struct RowCfg<float> {  // CUDA cores
  static constexpr int UB = 16, STAGES = 1, PAD = 4;
};

template <typename T, int D>
struct RowSmem {
  static constexpr int UB = RowCfg<T>::UB, PAD = RowCfg<T>::PAD, STAGES = RowCfg<T>::STAGES;
  static constexpr int LDG = D + PAD;         // g tile and Wgz block rows
  static constexpr int LDWD = UB + PAD;       // Wd block rows
  static constexpr int LDDG = 2 * UB + PAD;   // dgz block rows
  static constexpr int g = TR * LDG;          // elements of each buffer
  static constexpr int wd = D * LDWD;
  static constexpr int wgz = 2 * UB * LDG;
  static constexpr int dg = TR * LDDG;
  static constexpr int elems = g + STAGES * (wd + wgz) + dg;
  static constexpr int floats = TR + 4 * 2 * UB + 2 * TR + 4 * D;  // r, dbgz, dot, dwn sums
  static constexpr size_t bytes = sizeof(T) * (size_t)elems + 4 * (size_t)floats;
};
static_assert(RowSmem<bf16, 384>::bytes <= 232448, "a block's shared memory on Hopper");
static_assert(RowSmem<float, 384>::bytes <= 232448, "a block's shared memory on Hopper");

using tc::ld2;
using tc::prod16;
using tc::st2;
using tc::sum_over_cols;
using tc::sum_over_rows;

// Wd[:, ub:ub+UB] into sWd (D, UB) and Wgz rows ub.. and U + ub.. into sWgz
// (2 UB, D), 16 bytes a copy.
template <typename T, int D>
__device__ __forceinline__ void load_weights(T* sWd, T* sWgz, const T* wd, const T* wgz, int U,
                                             int ub) {
  using Sm = RowSmem<T, D>;
  constexpr int E = 16 / sizeof(T), UB = Sm::UB;  // elements a copy
  constexpr int CW = UB / E, CD = D / E;
  for (int e = threadIdx.x; e < D * CW; e += NT) {
    const int r = e / CW, c = e - r * CW;
    tc::cp_async16(sWd + r * Sm::LDWD + E * c, wd + (size_t)r * U + ub + E * c, true);
  }
  for (int e = threadIdx.x; e < 2 * UB * CD; e += NT) {
    const int r = e / CD, c = e - r * CD;
    const int row = r < UB ? ub + r : U + ub + (r - UB);
    tc::cp_async16(sWgz + r * Sm::LDG + E * c, wgz + (size_t)row * D + E * c, true);
  }
}

// Warp w computes rows 16 (w % 4).. of the tile; of dact the columns
// (w / 4) UB / 2.. of the U block, of dxn the columns (w / 4) D / 2.. of D.
template <typename T, int D>
__global__ void __launch_bounds__(NT, 1) ffn_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ gz, const T* __restrict__ g,
    const float* __restrict__ wn, const T* __restrict__ wgz, const T* __restrict__ wd,
    T* __restrict__ dx, T* __restrict__ xn, T* __restrict__ act, T* __restrict__ dgz,
    float* __restrict__ part, int M, int U, float eps) {
  using Sm = RowSmem<T, D>;
  constexpr int UB = Sm::UB, LDG = Sm::LDG, LDWD = Sm::LDWD, LDDG = Sm::LDDG;
  constexpr int NJA = UB / 16;  // n-tiles of 8 columns of dact per warp
  constexpr int NTD = D / 16;   // n-tiles of 8 columns of dxn per warp
  static_assert(NTD % 2 == 0, "two n-tiles per B load");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sg = reinterpret_cast<T*>(smem_raw);       // (TR, D) g
  T* sWd = sg + Sm::g;                          // STAGES x (D, UB)
  T* sWgz = sWd + Sm::STAGES * Sm::wd;          // STAGES x (2 UB, D)
  T* sdg = sWgz + Sm::STAGES * Sm::wgz;         // (TR, 2 UB) dgz of the block, in T
  float* srr = reinterpret_cast<float*>(sdg + Sm::dg);  // (TR) r
  float* scs = srr + TR;                        // (4, 2 UB) dgate | dz column sums
  float* sdot = scs + 4 * 2 * UB;               // (2, TR) sum(dxn * wn * x) halves
  float* swn = sdot + 2 * TR;                   // (4, D) dwn column sums

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rg = warp & 3, ch = warp >> 2;
  const int m0 = blockIdx.x * TR;
  const int W2 = 2 * U;
  float* prow = part + (size_t)blockIdx.x * (2 * D + W2);  // [dwn | dbd | dbgz]

  constexpr int E = 16 / sizeof(T), CD = D / E;
  for (int e = tid; e < TR * CD; e += NT) {
    const int r = e / CD, c = e - r * CD;
    const bool ok = m0 + r < M;
    tc::cp_async16(sg + r * LDG + E * c, g + (size_t)(ok ? m0 + r : 0) * D + E * c, ok);
  }
  load_weights<T, D>(sWd, sWgz, wd, wgz, U, 0);
  tc::cp_async_commit();

  // the norm: r per row (0 past M), xn = T((x r) wn) for dWgz
  for (int r = warp; r < TR; r += NT / 32) {
    const int m = m0 + r;
    float s = 0.f;
    if (m < M)
      for (int c = 2 * lane; c < D; c += 64) {
        const float2 v = ld2(x + (size_t)m * D + c);
        s = fmaf(v.x, v.x, s);
        s = fmaf(v.y, v.y, s);
      }
    s = sum_over_rows(sum_over_cols(s));
    const float rr = m < M ? rsqrtf(s / D + eps) : 0.f;
    if (lane == 0) srr[r] = rr;
    if (m < M)
      for (int c = 2 * lane; c < D; c += 64) {
        const float2 v = ld2(x + (size_t)m * D + c);
        st2(xn + (size_t)m * D + c, (v.x * rr) * wn[c], (v.y * rr) * wn[c + 1]);
      }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  for (int c = tid; c < D; c += NT) {  // dbd: column sums of g (rows past M are 0)
    float s = 0.f;
    for (int r = 0; r < TR; ++r) s += to_f32(sg[r * LDG + c]);
    prow[D + c] = s;
  }

  float acc[NTD][4];
#pragma unroll
  for (int j = 0; j < NTD; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int NU = U / UB;
  for (int it = 0; it < NU; ++it) {
    const int ub = it * UB;
    const int stage = Sm::STAGES == 2 ? (it & 1) : 0;
    const T* cWd = sWd + stage * Sm::wd;
    const T* cWgz = sWgz + stage * Sm::wgz;
    if (Sm::STAGES == 2 && it + 1 < NU) {  // the next block's weights, while this one computes
      load_weights<T, D>(sWd + (stage ^ 1) * Sm::wd, sWgz + (stage ^ 1) * Sm::wgz, wd, wgz, U,
                         ub + UB);
      tc::cp_async_commit();
    }

    // the gate and z of this thread's dact entries, loaded ahead of the product
    float2 gv[NJA][2], zv[NJA][2];
#pragma unroll
    for (int j = 0; j < NJA; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * rg + gq + 8 * h;
        const int u = ub + ch * (UB / 2) + 8 * j + 2 * tq;
        gv[j][h] = zv[j][h] = make_float2(0.f, 0.f);
        if (m < M) {
          gv[j][h] = ld2(gz + (size_t)m * W2 + u);
          zv[j][h] = ld2(gz + (size_t)m * W2 + U + u);
        }
      }

    // dact = g Wd[:, ub:ub+UB]
    float da[NJA][4];
#pragma unroll
    for (int j = 0; j < NJA; ++j) da[j][0] = da[j][1] = da[j][2] = da[j][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk)
      prod16<NJA, false, true>(da, sg, LDG, 16 * rg, cWd, LDWD, ch * (UB / 2), 16 * kk);

    // the gate backward on the accumulators
#pragma unroll
    for (int j = 0; j < NJA; ++j) {
      const int col = ch * (UB / 2) + 8 * j + 2 * tq;  // in the block
      const int u = ub + col;
      float sg_[2] = {0.f, 0.f}, sz_[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * rg + gq + 8 * h;
        const int m = m0 + row;
        const float gate[2] = {gv[j][h].x, gv[j][h].y}, zz[2] = {zv[j][h].x, zv[j][h].y};
        float dgt[2], dz[2], av[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sig = 1.f / (1.f + expf(-gate[e]));
          const float sil = gate[e] * sig;
          const float d = da[j][2 * h + e];
          dz[e] = d * sil;
          dgt[e] = d * zz[e] * (sig + sil * (1.f - sig));
          av[e] = rt<T>(sil) * zz[e];
          sg_[e] += dgt[e];
          sz_[e] += dz[e];
        }
        st2(sdg + row * LDDG + col, dgt[0], dgt[1]);
        st2(sdg + row * LDDG + UB + col, dz[0], dz[1]);
        if (m < M) {
          st2(act + (size_t)m * U + u, av[0], av[1]);
          st2(dgz + (size_t)m * W2 + u, dgt[0], dgt[1]);
          st2(dgz + (size_t)m * W2 + U + u, dz[0], dz[1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float s_g = sum_over_rows(sg_[e]), s_z = sum_over_rows(sz_[e]);
        if (gq == 0) {
          scs[rg * 2 * UB + col + e] = s_g;
          scs[rg * 2 * UB + UB + col + e] = s_z;
        }
      }
    }
    __syncthreads();
    for (int c = tid; c < 2 * UB; c += NT)
      prow[2 * D + (c < UB ? ub + c : U + ub + (c - UB))] =
          scs[c] + scs[2 * UB + c] + scs[4 * UB + c] + scs[6 * UB + c];

    // dxn += dgz_blk Wgz[rows ub.. and U + ub..]
#pragma unroll
    for (int kk = 0; kk < 2 * UB / 16; ++kk)
      prod16<NTD, false, true>(acc, sdg, LDDG, 16 * rg, cWgz, LDG, ch * (D / 2), 16 * kk);
    if (Sm::STAGES == 1 && it + 1 < NU) {  // one buffer: the next block's weights now
      __syncthreads();
      load_weights<T, D>(sWd, sWgz, wd, wgz, U, ub + UB);
      tc::cp_async_commit();
    }
    tc::cp_async_wait<0>();
    __syncthreads();
  }

  // the RMSNorm backward from dxn in registers
  const int cbase = ch * (D / 2);
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NTD; ++j) {
    const int c = cbase + 8 * j + 2 * tq;
    const float w0 = wn[c], w1 = wn[c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * rg + gq + 8 * h;
      if (m < M) {
        const float2 xv = ld2(x + (size_t)m * D + c);
        dot[h] = fmaf(acc[j][2 * h] * w0, xv.x, dot[h]);
        dot[h] = fmaf(acc[j][2 * h + 1] * w1, xv.y, dot[h]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dot[h] = sum_over_cols(dot[h]);
    if (tq == 0) sdot[ch * TR + 16 * rg + gq + 8 * h] = dot[h];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NTD; ++j) {
    const int c = cbase + 8 * j + 2 * tq;
    const float w0 = wn[c], w1 = wn[c + 1];
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * rg + gq + 8 * h;
      const int m = m0 + row;
      if (m < M) {
        const float rr = srr[row];
        const float k3 = (sdot[row] + sdot[TR + row]) * (rr * rr * rr) / D;
        const float2 xv = ld2(x + (size_t)m * D + c);
        st2(dx + (size_t)m * D + c, acc[j][2 * h] * w0 * rr - xv.x * k3,
            acc[j][2 * h + 1] * w1 * rr - xv.y * k3);
        s0 = fmaf(acc[j][2 * h], xv.x * rr, s0);
        s1 = fmaf(acc[j][2 * h + 1], xv.y * rr, s1);
      }
    }
    s0 = sum_over_rows(s0);
    s1 = sum_over_rows(s1);
    if (gq == 0) {
      swn[rg * D + c] = s0;
      swn[rg * D + c + 1] = s1;
    }
  }
  __syncthreads();
  for (int c = tid; c < D; c += NT) prow[c] = swn[c] + swn[D + c] + swn[2 * D + c] + swn[3 * D + c];
}

template <typename T, int D>
int run(const void* x_, const void* gz_, const void* g_, const float* wn, const void* wgz_,
        const void* wd_, void* dx, float* dvec, float* dwgz, float* dwd, void* xn_, void* act_,
        void* dgz_, float* part_vec, float* part_w, int M, int U, int splits_d, int splits_gz,
        float eps, cudaStream_t st) {
  const T *x = static_cast<const T*>(x_), *gz = static_cast<const T*>(gz_),
          *g = static_cast<const T*>(g_);
  T *xn = static_cast<T*>(xn_), *act = static_cast<T*>(act_), *dgz = static_cast<T*>(dgz_);
  const int tiles = cdiv(M, TR);
  const size_t smem = RowSmem<T, D>::bytes;
  cudaError_t err = allow_smem(ffn_rows_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  ffn_rows_kernel<T, D><<<tiles, NT, smem, st>>>(
      x, gz, g, wn, static_cast<const T*>(wgz_), static_cast<const T*>(wd_), static_cast<T*>(dx),
      xn, act, dgz, part_vec, M, U, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<cdiv(2 * D + 2 * U, 32), NT, 0, st>>>(part_vec, dvec, tiles, 2 * D + 2 * U);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dWd (D, U) = g^T act; dWgz (2U, D) = dgz^T xn
  err = launch_wgrad_any(g, act, part_w, dwd, M, D, U, splits_d, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad_any(dgz, xn, part_w, dwgz, M, 2 * U, D, splits_gz, st);
}

template <typename T>
int run_d(int D, const void* x, const void* gz, const void* g, const float* wn, const void* wgz,
          const void* wd, void* dx, float* dvec, float* dwgz, float* dwd, void* xn, void* act,
          void* dgz, float* part_vec, float* part_w, int M, int U, int splits_d, int splits_gz,
          float eps, cudaStream_t st) {
  switch (D) {
#define FFN_D(DD)                                                                        \
  case DD:                                                                               \
    return run<T, DD>(x, gz, g, wn, wgz, wd, dx, dvec, dwgz, dwd, xn, act, dgz, part_vec, \
                      part_w, M, U, splits_d, splits_gz, eps, st);
    FFN_D(32)
    FFN_D(192)
    FFN_D(256)
    FFN_D(384)
#undef FFN_D
    default: return 1000;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Weights wn (D) float32; wgz (2U, D) and
// wd (D, U) in the dtype.  Outputs: dx (M, D) in the dtype; dvec = [dwn (D),
// dbd (D), dbgz (2U)], dwgz (2U, D), dwd (D, U) float32.  Scratch: xn (M, D),
// act (M, U), dgz (M, 2U) in the dtype; part_vec (ceil(M / 64), 2D + 2U)
// and part_w (max(splits_d D U, splits_gz 2U D)) float32, splits_d and
// splits_gz the row ranges of the two weight gradients.  Returns a CUDA
// error code (0 = launched); 1000 for a dtype, D or U it does not take (D
// 32, 192, 256 or 384, U a multiple of 32).
extern "C" int ffn_bw(const void* x, const void* gz, const void* g, const float* wn,
                      const void* wgz, const void* wd, void* dx, float* dvec, float* dwgz,
                      float* dwd, void* xn, void* act, void* dgz, float* part_vec,
                      float* part_w, int M, int D, int U, int splits_d, int splits_gz, int dtype,
                      float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (U % 32) return 1000;
  if (dtype == 0)
    return run_d<float>(D, x, gz, g, wn, wgz, wd, dx, dvec, dwgz, dwd, xn, act, dgz, part_vec,
                        part_w, M, U, splits_d, splits_gz, eps, st);
  if (dtype == 1)
    return run_d<bf16>(D, x, gz, g, wn, wgz, wd, dx, dvec, dwgz, dwd, xn, act, dgz, part_vec,
                       part_w, M, U, splits_d, splits_gz, eps, st);
  return 1000;
}
