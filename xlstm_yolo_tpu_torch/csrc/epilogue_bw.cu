// Backward of the ViLLayer training epilogue [per-head LayerNorm -> + skip * x
// -> proj_down] for Hopper, sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` of xlstm_yolo_tpu/ops/pallas/
// epilogue.py:70 (launched by `_epilogue_bwd_pallas` :165).  It computes what
// that kernel computes, for the forward of xlstm_yolo_tpu_torch/ops/
// epilogue.py (`epilogue_forward`), with rows m = (b, s) of M = B * S and
// T the compute dtype:
//
//   hhat = (h - mean_head) * rstd,  rstd = rsqrt(E_head[(h - mean)^2] + eps)
//   z    = T(T(hhat * (1 + ln_w) + ln_b) + T(T(skip) * x))
//   dz   = T(g) T(Wd)  (float32; Wd = proj_down weight (D, H))
//   dx   = dz * skip,  dskip = sum_m dz * x,  dln_w = sum_m dz * hhat,
//   dln_b = sum_m dz,  dbd = sum_m g,  dWd = T(g)^T T(z)  (float32),
//   dh   = rstd * (dhhat - mean_head(dhhat) - hhat * mean_head(dhhat * hhat)),
//   dhhat = dz * (1 + ln_w).
//
// The variance is the centred E[(x - m)^2] (the raw-moment form cancels
// for large-mean rows and goes negative in float32).  Any S: the rows form
// one flat range M, the last tile is masked.
//
// What bounds it.  At B 8, S 6400 (M 51,200), H 768, D 384 in bf16 the two
// products are 60 GFLOP (0.061 ms on the tensor cores) and the function
// moves ~0.35 GB (0.106 ms at 3.35 TB/s): bound by bytes.
//
// Design.  Three steps on the caller's stream, the products in the mma
// fragment layout (tc::prod16, csrc/mma.cuh): on the tensor cores
// (mma.sync m16n8k16, bf16 operands, float32 sums) for bf16, as float32
// FMA for float32:
//  1. rows (epilogue_rows_kernel): one block of 8 warps per tile of 64
//     rows walks the heads.  A head is a DH-wide column slice of H, so its
//     LayerNorm backward needs only its own columns: for each head, dz_head
//     (64 x DH) = g (64 x D) Wd[:, head], the g tile staged once in shared
//     memory and Wd (cast to T once a call by the wrapper) streamed in
//     slabs of 64 of its D rows through a cp.async double buffer (a whole
//     head block of Wd, 96 KB at D 384, DH 128, would not fit twice beside
//     the g tile).  Warp w owns rows 16 (w % 4).. and half of the head's
//     columns; the row statistics of h (mean, centred variance) and of
//     dhhat pass between the two halves through shared memory.  Then, in
//     float32, dh, dx and z (T, for step 2) go out, and the tile's column
//     sums of dln_w, dln_b, dskip (over its rows, per head) and of g (dbd);
//  2. dWd = g^T z over row ranges (split-K) by wgrad_tc_kernel (csrc/
//     wgrad.cuh, shared with the FFN backward; float32: wgrad_kernel);
//  3. reduce_kernel: the per-tile and per-range partials summed in a fixed
//     order: the parameter gradients are deterministic (no atomics).
// Shared memory at D 384, DH 128: 93 KB in bf16 (two blocks an SM), 175 KB
// in float32.
// The kernel takes the detectors' (D, DH): (32, 16), (192, 32), (256, 64)
// and (384, 128), H = 2 D.

#include "common.cuh"
#include "mma.cuh"
#include "wgrad.cuh"

namespace {

using namespace port;
using tc::bf16;
using tc::ld2;
using tc::pad;
using tc::prod16;
using tc::st2;
using tc::sum_over_cols;
using tc::sum_over_rows;

constexpr int TR = 64;  // rows of a tile
constexpr int KS = 64;  // rows of Wd a slab (D 32: the whole 32)

template <typename T, int D, int DH>
struct EpiSmem {
  static constexpr int KSL = D < KS ? D : KS;  // rows a slab
  static constexpr int LDG = D + pad<T>(), LDW = DH + pad<T>();
  static constexpr size_t bytes =
      sizeof(T) * (TR * LDG + 2 * KSL * LDW) + 4 * (8 * TR + 3 * 4 * DH);
};
static_assert(EpiSmem<bf16, 384, 128>::bytes <= 232448, "a block's shared memory on Hopper");
static_assert(EpiSmem<float, 384, 128>::bytes <= 232448, "a block's shared memory on Hopper");

template <typename T, int D, int DH>
__global__ void __launch_bounds__(NT) epilogue_rows_kernel(
    const T* __restrict__ h, const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ lnw, const float* __restrict__ lnb,
    const float* __restrict__ skip, const T* __restrict__ wd, T* __restrict__ dh,
    T* __restrict__ dx, T* __restrict__ z, float* __restrict__ part, int M, float eps) {
  using Sm = EpiSmem<T, D, DH>;
  constexpr int H = 2 * D, NH = H / DH;
  constexpr int KSL = Sm::KSL, LDG = Sm::LDG, LDW = Sm::LDW;
  constexpr int NSL = D / KSL;  // slabs a head
  constexpr int NJ = DH / 16;   // n-tiles of 8 columns a warp (half of DH)
  constexpr int E = 16 / sizeof(T);
  static_assert(H % DH == 0 && D % KSL == 0 && DH % 16 == 0, "the detectors' widths");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sg = reinterpret_cast<T*>(smem_raw);  // (TR, LDG) g
  T* sw = sg + TR * LDG;                   // 2 x (KSL, LDW) a slab of Wd[:, head]
  float* smean = reinterpret_cast<float*>(sw + 2 * KSL * LDW);  // (2, TR) row sums of h
  float* svar = smean + 2 * TR;            // (2, TR) of (h - mean)^2
  float* sdd = svar + 2 * TR;              // (2, 2, TR) of dhhat and dhhat * hhat
  float* scol = sdd + 4 * TR;              // (3, 4, DH) column sums per row group

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rg = warp & 3, ch = warp >> 2;
  const int m0 = blockIdx.x * TR;
  float* prow = part + (size_t)blockIdx.x * (3 * H + D);  // [dln_w | dln_b | dskip | dbd]

  auto load_slab = [&](int t, int buf) {  // slab t: head t / NSL, rows (t % NSL) KSL..
    const int hd = t / NSL, d0 = (t - hd * NSL) * KSL;
    constexpr int CW = DH / E;
    for (int e = tid; e < KSL * CW; e += NT) {
      const int r = e / CW, c = e - r * CW;
      tc::cp_async16(sw + buf * KSL * LDW + r * LDW + E * c,
                     wd + (size_t)(d0 + r) * H + hd * DH + E * c, true);
    }
    tc::cp_async_commit();
  };

  constexpr int CD = D / E;
  for (int e = tid; e < TR * CD; e += NT) {
    const int r = e / CD, c = e - r * CD;
    const bool ok = m0 + r < M;
    tc::cp_async16(sg + r * LDG + E * c, g + (size_t)(ok ? m0 + r : 0) * D + E * c, ok);
  }
  load_slab(0, 0);  // committed with the g tile

  // the thread's rows (within the tile) and whether they exist
  int rows[2];
  bool live[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rows[hh] = 16 * rg + gq + 8 * hh;
    live[hh] = m0 + rows[hh] < M;
  }

  const int NS = NH * NSL;
  for (int hd = 0; hd < NH; ++hd) {
    // dz = g Wd[:, head] on the warp's rows and half of the head's columns
    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int s = 0; s < NSL; ++s) {
      const int t = hd * NSL + s, buf = t & 1;
      if (t + 1 < NS) {
        load_slab(t + 1, buf ^ 1);
        tc::cp_async_wait<1>();
      } else {
        tc::cp_async_wait<0>();
      }
      __syncthreads();
      if (t == 0)
        for (int c = tid; c < D; c += NT) {  // dbd: column sums of g (rows past M are 0)
          float sum = 0.f;
          for (int r = 0; r < TR; ++r) sum += to_f32(sg[r * LDG + c]);
          prow[3 * H + c] = sum;
        }
#pragma unroll
      for (int kk = 0; kk < KSL / 16; ++kk)
        prod16<NJ, false, true>(acc, sg + s * KSL, LDG, 16 * rg, sw + buf * KSL * LDW, LDW,
                                ch * (DH / 2), 16 * kk);
      __syncthreads();  // before the next load refills this slab's buffer
    }

    // h of the thread's entries; the head's row mean of h
    const int col0 = hd * DH + ch * (DH / 2) + 2 * tq;  // + 8 j
    float2 hv[NJ][2];
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        hv[j][hh] = live[hh] ? ld2(h + (size_t)(m0 + rows[hh]) * H + col0 + 8 * j)
                             : make_float2(0.f, 0.f);
        s[hh] += hv[j][hh].x + hv[j][hh].y;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      s[hh] = sum_over_cols(s[hh]);
      if (tq == 0) smean[ch * TR + rows[hh]] = s[hh];
    }
    __syncthreads();
    float mean[2], ss[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      mean[hh] = (smean[rows[hh]] + smean[TR + rows[hh]]) / DH;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float a = hv[j][hh].x - mean[hh], b = hv[j][hh].y - mean[hh];
        ss[hh] = fmaf(a, a, ss[hh]);
        ss[hh] = fmaf(b, b, ss[hh]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ss[hh] = sum_over_cols(ss[hh]);
      if (tq == 0) svar[ch * TR + rows[hh]] = ss[hh];
    }
    __syncthreads();
    float rstd[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      rstd[hh] = rsqrtf((svar[rows[hh]] + svar[TR + rows[hh]]) / DH + eps);

    // hhat in place of h; z and dx out; the sums of dhhat and dhhat * hhat
    // per row, and the column sums of dz hhat, dz and dz x over the warp's rows
    float d1[2] = {0.f, 0.f}, d2[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = col0 + 8 * j;
      const float w1[2] = {1.f + lnw[c], 1.f + lnw[c + 1]}, bb[2] = {lnb[c], lnb[c + 1]};
      const float sk[2] = {skip[c], skip[c + 1]};
      const float skr[2] = {rt<T>(sk[0]), rt<T>(sk[1])};
      float cw[2][3] = {};  // dln_w, dln_b, dskip of the two columns
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const size_t off = (size_t)(m0 + rows[hh]) * H + c;
        const float2 xl = live[hh] ? ld2(x + off) : make_float2(0.f, 0.f);
        const float hx[2] = {hv[j][hh].x, hv[j][hh].y}, xx[2] = {xl.x, xl.y};
        float hat[2], zz[2], dxx[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          hat[e] = (hx[e] - mean[hh]) * rstd[hh];
          zz[e] = rt<T>(rt<T>(fmaf(hat[e], w1[e], bb[e])) + rt<T>(skr[e] * xx[e]));
          const float d = acc[j][2 * hh + e];
          dxx[e] = d * sk[e];
          const float dhh = d * w1[e];
          d1[hh] += dhh;
          d2[hh] = fmaf(dhh, hat[e], d2[hh]);
          cw[e][0] = fmaf(d, hat[e], cw[e][0]);
          cw[e][1] += d;
          cw[e][2] = fmaf(d, xx[e], cw[e][2]);
        }
        hv[j][hh] = make_float2(hat[0], hat[1]);
        if (live[hh]) {
          st2(z + off, zz[0], zz[1]);
          st2(dx + off, dxx[0], dxx[1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float sum = sum_over_rows(cw[e][v]);
          if (gq == 0) scol[(v * 4 + rg) * DH + ch * (DH / 2) + 8 * j + 2 * tq + e] = sum;
        }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      d1[hh] = sum_over_cols(d1[hh]);
      d2[hh] = sum_over_cols(d2[hh]);
      if (tq == 0) {
        sdd[(ch * 2 + 0) * TR + rows[hh]] = d1[hh];
        sdd[(ch * 2 + 1) * TR + rows[hh]] = d2[hh];
      }
    }
    __syncthreads();
    // dh = rstd (dhhat - mean(dhhat) - hhat mean(dhhat hhat))
    float mdh[2], mdhh[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mdh[hh] = (sdd[0 * TR + rows[hh]] + sdd[2 * TR + rows[hh]]) / DH;
      mdhh[hh] = (sdd[1 * TR + rows[hh]] + sdd[3 * TR + rows[hh]]) / DH;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = col0 + 8 * j;
      const float w1[2] = {1.f + lnw[c], 1.f + lnw[c + 1]};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!live[hh]) continue;
        const float hat[2] = {hv[j][hh].x, hv[j][hh].y};
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[e] = rstd[hh] * (acc[j][2 * hh + e] * w1[e] - mdh[hh] - hat[e] * mdhh[hh]);
        st2(dh + (size_t)(m0 + rows[hh]) * H + c, o[0], o[1]);
      }
    }
    for (int e = tid; e < 3 * DH; e += NT) {  // the tile's column sums of this head
      const int v = e / DH, c = e - v * DH;
      const float* p = scol + v * 4 * DH + c;
      prow[v * H + hd * DH + c] = p[0] + p[DH] + p[2 * DH] + p[3 * DH];
    }
    // the next head's first __syncthreads (in its slab loop) orders these
    // reads of smean, svar, sdd and scol before their next writes
  }
}

template <typename T, int D, int DH>
int run(const void* h, const void* x, const void* g, const float* lnw, const float* lnb,
        const float* skip, const void* wd, void* dh, void* dx, float* dvec, float* dwd, void* z,
        float* part_vec, float* part_w, int M, int splits, float eps, cudaStream_t st) {
  constexpr int H = 2 * D;
  const int tiles = cdiv(M, TR);
  const size_t smem = EpiSmem<T, D, DH>::bytes;
  cudaError_t err = allow_smem(epilogue_rows_kernel<T, D, DH>, smem);
  if (err != cudaSuccess) return (int)err;
  epilogue_rows_kernel<T, D, DH><<<tiles, NT, smem, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(x), static_cast<const T*>(g), lnw, lnb,
      skip, static_cast<const T*>(wd), static_cast<T*>(dh), static_cast<T*>(dx),
      static_cast<T*>(z), part_vec, M, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_kernel<<<cdiv(3 * H + D, 32), NT, 0, st>>>(part_vec, dvec, tiles, 3 * H + D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dWd (D, H) = g^T z
  return (int)launch_wgrad_any(static_cast<const T*>(g), static_cast<const T*>(z), part_w, dwd,
                               M, D, H, splits, st);
}

template <typename T>
int run_widths(int H, int D, int NH, const void* h, const void* x, const void* g,
               const float* lnw, const float* lnb, const float* skip, const void* wd, void* dh,
               void* dx, float* dvec, float* dwd, void* z, float* part_vec, float* part_w, int M,
               int splits, float eps, cudaStream_t st) {
  if (H != 2 * D) return 1000;
#define EPI_W(DD, DHH)                                                                        \
  if (D == DD && H / NH == DHH && H % NH == 0)                                                \
    return run<T, DD, DHH>(h, x, g, lnw, lnb, skip, wd, dh, dx, dvec, dwd, z, part_vec, part_w, \
                           M, splits, eps, st);
  EPI_W(32, 16)
  EPI_W(192, 32)
  EPI_W(256, 64)
  EPI_W(384, 128)
#undef EPI_W
  return 1000;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  h, x (M, H) and g (M, D) in the
// dtype; ln_w, ln_b, skip (H) float32, wd (D, H) in the dtype.  Outputs:
// dh, dx (M, H) in the dtype; dvec = [dln_w (H), dln_b (H), dskip (H),
// dbd (D)] and dwd (D, H) float32.  Scratch: z (M, H) in the dtype,
// part_vec (ceil(M / 64), 3H + D) and part_w (splits, D, H) float32.
// Returns a CUDA error code (0 = launched); 1000 for a dtype or (H, D, NH)
// it does not take (H = 2 D; D, H / NH: 32, 16; 192, 32; 256, 64; 384, 128).
extern "C" int epilogue_bw(const void* h, const void* x, const void* g, const float* lnw,
                           const float* lnb, const float* skip, const void* wd, void* dh,
                           void* dx, float* dvec, float* dwd, void* z, float* part_vec,
                           float* part_w, int M, int H, int D, int NH, int splits, int dtype,
                           float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_widths<float>(H, D, NH, h, x, g, lnw, lnb, skip, wd, dh, dx, dvec, dwd, z,
                             part_vec, part_w, M, splits, eps, st);
  if (dtype == 1)
    return run_widths<bf16>(H, D, NH, h, x, g, lnw, lnb, skip, wd, dh, dx, dvec, dwd, z,
                            part_vec, part_w, M, splits, eps, st);
  return 1000;
}
