// Quadratic (parallel) sigmoid-input-gate mLSTM forward for Hopper, sm_90a.
//
// Replaces the TPU kernel `_fw_kernel` (xlstm_yolo_tpu/ops/pallas/
// parallel.py:48, launched by `_fw` :172, call :205).  For every
// (batch * head) and query row l, with D as in parallel.cuh:
//
//   sd[l, j] = (R(q_l) . R(k_j)) scale * D[l, j]
//   h_l      = sum_j R(sd[l, j]) R(v_j) / (den_l + eps)
//   den_l    = max(|sum_j sd[l, j]|, 1)            (written for the backward)
//
// h in the storage type, den float32.  R() rounds to the compute type where
// the TPU kernel casts (`:68, :74`); sums are float32, den's from the
// unrounded sd.
//
// What bounds it.  The function reads q, k, v and the gate rows once and
// writes h and den: 171 MB at the flagship's S = 6656 (B 8, NH 12, DH 32,
// bf16), 51 us at 3.35 TB/s.  Its two products over the S (S + 1) / 2
// causal pairs of each (batch, head) are 4 DH flop a pair, 272 GFLOP, 275
// us at the bf16 tensor-core peak (550 us at vil-det-384's NH 6, DH 128).
// Each pair also needs one exp: 2.13e9 of them at DH 32, >= 0.51 ms at 16
// ex2 a clock on each of 132 SMs at 1980 MHz (0.25 ms at DH 128), and
// some seven float32 operations beside it.  So the exps and the scalar
// work around them bound it at DH 32, the products at DH 128.
//
// Design.  The TPU kernel keeps all of K and V of a (batch, head) in VMEM
// and makes one (TQ x S) score tile per grid step; here a block of 4 warps
// owns 64 query rows, each warp 16 whole rows, and walks the 64-row key
// tiles up to its diagonal, staged into padded shared memory two deep
// (cp.async; in the compute type, so a float32 stream with bf16 products
// is rounded on the way in, through registers).  Per key tile a warp makes
// its (16 x 64) score fragment Q K^T on the tensor cores (mma.sync
// m16n8k16, float32 sums), scales it by D in registers (one __expf a pair;
// only the diagonal tile is masked: the key tiles below it are whole),
// adds its row sums for den, and multiplies the fragment, rounded to bf16,
// by V (ldmatrix .trans) without leaving the registers.  h and the row
// sums accumulate in registers; den's four partial sums of a row meet by
// two shuffles at the end, and no score tile goes to shared memory.  With
// float32 products the same tiling runs as float32 FMA (tc::prod16), the
// score fragment going through the warp's scratch rows.  Blocks are
// launched heaviest first (the longest walks, heavy_first).  Shared memory
// at DH 128: 87 KB in bf16 (two blocks an SM), 187 KB in float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "parallel.cuh"

using namespace par;

namespace {

template <typename CT, int DH>
struct FwSmem {
  static constexpr int LD = DH + tc::pad<CT>();
  static constexpr size_t bytes =
      sizeof(CT) * 5 * TR * LD + 4 * (4 * TR + 4 * scratch_floats<CT, TR / 8>());
};
static_assert(FwSmem<float, 128>::bytes <= 232448, "a block's shared memory on Hopper");

}  // namespace

template <typename T, typename CT, int DH>
__global__ void __launch_bounds__(NTC) parallel_fw_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ b, const float* __restrict__ li, T* __restrict__ h,
    float* __restrict__ den_out, int S, float qk_scale, float eps) {
  constexpr int LD = FwSmem<CT, DH>::LD;
  constexpr int NS = TR / 8;  // n-tiles of 8 keys in a score fragment
  constexpr int NJ = DH / 8;  // n-tiles of 8 columns of h
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CT* sq = reinterpret_cast<CT*>(smem_raw);  // (TR, LD) R(q)
  CT* sk = sq + TR * LD;                     // 2 x (TR, LD) R(k) of a key tile
  CT* sv = sk + 2 * TR * LD;                 // 2 x (TR, LD) R(v)
  float* sbk = reinterpret_cast<float*>(sv + 2 * TR * LD);  // 2 x (TR) b of the keys
  float* slk = sbk + 2 * TR;                                // 2 x (TR) logsig(i)
  float* scratch = slk + 2 * TR + threadIdx.x / 32 * scratch_floats<CT, NS>();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = heavy_first(blockIdx.y, tiles(S), true);
  const size_t base = (size_t)blockIdx.x * S;  // first row of this (batch, head)
  const int q0 = qt * TR, l0 = 16 * warp;
  const T* kb = k + base * DH;
  const T* vb = v + base * DH;

  auto prefetch = [&](int kt, int buf) {
    const int k0 = kt * TR;
    stage_tile<T, CT, DH, LD>(sk + buf * TR * LD, kb, k0, S);
    stage_tile<T, CT, DH, LD>(sv + buf * TR * LD, vb, k0, S);
    for (int e = threadIdx.x; e < TR; e += NTC) {
      const bool ok = k0 + e < S;
      tc::cp_async4(sbk + buf * TR + e, ok ? b + base + k0 + e : b, ok);
      tc::cp_async4(slk + buf * TR + e, ok ? li + base + k0 + e : li, ok);
    }
    tc::cp_async_commit();
  };
  stage_tile<T, CT, DH, LD>(sq, q + base * DH, q0, S);
  prefetch(0, 0);

  // b of the warp's two rows of each lane; -inf past S, so that D is 0 there
  float bq[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int l = q0 + l0 + g + 8 * hh;
    bq[hh] = l < S ? b[base + l] : -CUDART_INF_F;
  }
  float acc[NJ][4], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = kt & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // key tile kt is in; every warp is done with tile kt - 1
    if (kt < qt) prefetch(kt + 1, buf ^ 1);
    const CT* ck = sk + buf * TR * LD;
    const CT* cv = sv + buf * TR * LD;
    const float* cb = sbk + buf * TR;
    const float* cl = slk + buf * TR;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      tc::prod16<NS, false, false>(s, sq, LD, l0, ck, LD, 0, 16 * kk);

    // sd = (q . k) scale D; the diagonal tile masks j > l before the exp
    auto decay = [&](auto diag) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int j = 8 * n + 2 * t;
        const float2 bj = *reinterpret_cast<const float2*>(cb + j);
        const float2 lj = *reinterpret_cast<const float2*>(cl + j);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int hh = x >> 1, e = x & 1;
          float ex = (bq[hh] - (e ? bj.y : bj.x)) + (e ? lj.y : lj.x);
          if (decltype(diag)::value && j + e > l0 + g + 8 * hh) ex = -CUDART_INF_F;
          const float sd = (s[n][x] * qk_scale) * __expf(ex);
          rsum[hh] += sd;
          s[n][x] = sd;
        }
      }
    };
    if (kt == qt) decay(std::true_type{});
    else decay(std::false_type{});

    score_times<NS, NJ>(acc, s, scratch, cv, LD);  // h += R(sd) R(v)
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float n = tc::sum_over_cols(rsum[hh]);
    const int l = q0 + l0 + g + 8 * hh;
    if (l >= S) continue;
    const float den = fmaxf(fabsf(n), 1.f);
    if (t == 0) den_out[base + l] = den;
    const float inv = den + eps;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      tc::st2(h + (base + l) * DH + 8 * j + 2 * t, acc[j][2 * hh] / inv,
              acc[j][2 * hh + 1] / inv);
  }
}

// dtype, cdtype: 0 = float32, 1 = bfloat16 (storage of q, k, v, h; compute
// type of the products).  b, li: the gate rows (B * NH, S) float32.  Outputs:
// h (B * NH, S, DH) in the storage type, den (B * NH, S) float32.  Returns a
// CUDA error code; 1000 for a dtype or head size the kernel does not take.
extern "C" int parallel_fw(const void* q, const void* k, const void* v, const float* b,
                           const float* li, void* h, float* den, int BNH, int S, int DH,
                           int dtype, int cdtype, float qk_scale, float eps, void* stream) {
  if (S <= 0 || BNH <= 0) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dh) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dh)::value;
    const size_t smem = FwSmem<CT, D>::bytes;
    cudaError_t err = port::allow_smem(parallel_fw_kernel<T, CT, D>, smem);
    if (err != cudaSuccess) return (int)err;
    parallel_fw_kernel<T, CT, D><<<dim3(BNH, tiles(S)), NTC, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), b, li,
        static_cast<T*>(h), den, S, qk_scale, eps);
    return (int)cudaGetLastError();
  });
}
