// Quadratic (parallel) sigmoid-input-gate mLSTM backward for Hopper, sm_90a:
// two kernels, as on the TPU.
//
// Replaces `_bw_dq_kernel` (xlstm_yolo_tpu/ops/pallas/parallel.py:84, call
// :256) and `_bw_dkv_kernel` (:117, call :277), launched by `_core_bwd`
// :235.  The denominator is held constant (the TPU VJP's semantics): with
// dhn_l = dh_l / (den_l + eps) in float32, D as in parallel.cuh,
//
//   dQ:    P[l, j] = (R(dhn_l) . R(v_j)) D[l, j],   dq_l = sum_j R(P[l, j]) R(k_j) scale
//   dK/dV: dk_j = sum_l R(P[l, j]) R(q_l) scale,
//          dv_j = sum_l R((R(k_j) . R(q_l)) scale D[l, j]) R(dhn_l)
//
// each written in the storage type, as the TPU kernels write dq in q's
// dtype and dk, dv in k's and v's.  R() rounds to the compute type where
// the TPU kernels cast (`:105-111, :140-163`); sums are float32.  The gate
// gradients are taken outside, in PyTorch, from these.  Every output row
// is written by one block: no atomics, and the result does not depend on
// the order in which blocks run.
//
// What bounds them.  dQ reads k, v, dh and den and writes dq; dK/dV reads
// q, k, v, dh and den and writes dk and dv (both also read the gate rows):
// 171 MB and 253 MB at the flagship's S = 6656 (B 8, NH 12, DH 32, bf16).
// Their causal products are 2 and 4 S^2 DH B NH flop (272 and 544 GFLOP,
// 275 and 550 us at the bf16 tensor-core peak; dK/dV 1.10 ms at
// vil-det-384's NH 6, DH 128), so both are bound by operations at the long
// sequences.  dK/dV also needs one exp a causal pair, shared by its two
// score products: >= 0.51 ms at DH 32 (16 ex2 a clock on each of 132 SMs
// at 1980 MHz), 0.25 ms at DH 128.
//
// dQ (parallel_bw_dq_kernel) has the forward's streams, products and exps,
// and its design (parallel_fw.cu): a block of 4 warps owns 64 query rows,
// each warp 16, stages the block's dh once and scales it in place to
// R(dhn) (float32 division, then the rounding; divided on the way in when
// the storage type is not the compute type), and walks the key tiles up to
// its diagonal, staging R(k), R(v) and the gate rows two deep by cp.async.
// Per key tile a warp makes P = R(dhn) R(v)^T as a (16 x 64) fragment on the
// tensor cores, scales it by D in registers (one __expf a pair; only the
// diagonal tile is masked, and rows past S have b = -inf, so the zero rows
// of a ragged last tile meet no overflowing e^{-b_j}), and multiplies it,
// rounded to bf16, by K (ldmatrix .trans) into dq, 16 x DH a warp in
// registers (dq_step, parallel.cuh).  Shared memory at DH 128: 87 KB in
// bf16, 188 KB in float32.
//
// dK/dV (parallel_bw_dkv_kernel): a block owns 128
// key rows with bf16 products (8 warps; 64 rows and 4 warps with float32
// products, whose tiles would not fit), each warp 16 keys, and walks the
// query tiles from the block's diagonal on (the column-causal walk),
// staging R(q), dh, b and den of a query tile two deep by cp.async, so
// each staged tile serves 128 keys; dh becomes R(dhn) in place (float32
// division, then the rounding) once it is in (through registers, divided
// on the way in, when the storage type is not the compute type).  Per
// query tile a warp makes S^T = K Q^T and P^T = V dhn^T as (16 x QW)
// fragments on the tensor cores (mma.sync m16n8k16), scales both by one
// exp a pair in registers (only the warp's diagonal tile and a ragged
// last tile are masked; a tile wholly before its keys is skipped), and
// multiplies them, rounded to bf16, by dhn and Q (ldmatrix .trans) into dv
// and dk without leaving the registers (dkv_step, parallel.cuh).  The trouble is registers: the dk
// and dv accumulators of 16 x DH and the two fragments come to ~200 a
// thread at DH 128 with 64 queries a step, so at DH 128 a query tile is
// taken in two steps of QW = 32 columns, one live at a time (-Xptxas -v
// reports the count).  With float32 products the same tiling runs as
// float32 FMA (tc::prod16), the fragments going through the warp's scratch
// rows.  Shared memory: own K and V, two query tiles of q and dh: 137 KB at
// DH 128 in bf16 (one block an SM), 217 KB in float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "parallel.cuh"

using namespace par;

namespace {

template <typename CT, int DH>
struct DqSmem {
  static constexpr int LD = DH + tc::pad<CT>();
  static constexpr size_t bytes =
      sizeof(CT) * 5 * TR * LD + 4 * (5 * TR + 4 * scratch_floats<CT, TR / 8>());
};
static_assert(DqSmem<float, 128>::bytes <= 232448, "a block's shared memory on Hopper");

}  // namespace

template <typename T, typename CT, int DH>
__global__ void __launch_bounds__(NTC) parallel_bw_dq_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ b,
    const float* __restrict__ li, const float* __restrict__ den, const T* __restrict__ dh,
    T* __restrict__ dq, int S, float qk_scale, float eps) {
  constexpr int LD = DqSmem<CT, DH>::LD;
  constexpr int NJ = DH / 8;  // n-tiles of 8 columns of dq
  constexpr bool RAW = std::is_same<T, CT>::value;  // dh staged unchanged, scaled in place
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CT* sn = reinterpret_cast<CT*>(smem_raw);  // (TR, LD) dh, then R(dhn)
  CT* sk = sn + TR * LD;                     // 2 x (TR, LD) R(k) of a key tile
  CT* sv = sk + 2 * TR * LD;                 // 2 x (TR, LD) R(v)
  float* sbk = reinterpret_cast<float*>(sv + 2 * TR * LD);  // 2 x (TR) b of the keys
  float* slk = sbk + 2 * TR;                                // 2 x (TR) logsig(i)
  float* sdq = slk + 2 * TR;                                // (TR) den of the query rows
  float* scratch = sdq + TR + threadIdx.x / 32 * scratch_floats<CT, TR / 8>();

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
  stage_tile<T, CT, DH, LD>(sn, dh + base * DH, q0, S, RAW ? nullptr : den + base, eps);
  for (int e = threadIdx.x; e < TR; e += NTC) {
    const bool ok = q0 + e < S;
    tc::cp_async4(sdq + e, ok ? den + base + q0 + e : den, ok);
  }
  prefetch(0, 0);  // one group with the dh tile

  // b of the warp's two rows of each lane; -inf past S, so that D is 0 there
  float bq[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int l = q0 + l0 + g + 8 * hh;
    bq[hh] = l < S ? b[base + l] : -CUDART_INF_F;
  }
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  walk_tiles(
      0, qt, prefetch,
      [&](int kt, int) {
        if (RAW && kt == 0) {  // dh is in: R(dhn) in place
          scale_rows<CT, DH, LD, NTC>(sn, sdq, eps);
          __syncthreads();
        }
      },
      [&](int kt, int buf) {
        const float* cb = sbk + buf * TR;
        const float* cl = slk + buf * TR;
        // the diagonal tile masks j > l before the exp
        auto step = [&](auto diag) {
          dq_step<DH>(acc, sn, l0, sk + buf * TR * LD, sv + buf * TR * LD, LD, scratch,
                      [&](int hh, int c) {
                        return decltype(diag)::value && c > l0 + g + 8 * hh
                                   ? -CUDART_INF_F
                                   : (bq[hh] - cb[c]) + cl[c];
                      });
        };
        if (kt == qt) step(std::true_type{});
        else step(std::false_type{});
      });

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int l = q0 + l0 + g + 8 * hh;
    if (l >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      tc::st2(dq + (base + l) * DH + 8 * j + 2 * t, acc[j][2 * hh] * qk_scale,
              acc[j][2 * hh + 1] * qk_scale);
  }
}

namespace {

// The tiling of a dK/dV block: TK own keys, 16 a warp (128 with bf16
// products, so each staged query tile serves twice the keys; 64 with
// float32 products, whose tiles would not fit), query tiles of TR rows
// taken QW columns a step.
template <typename CT, int DH>
struct DkvTile {
  static constexpr int TK = std::is_same<CT, tc::bf16>::value ? 128 : 64;
  static constexpr int NTH = 2 * TK;                // threads: TK / 16 warps
  static constexpr int LD = DH + tc::pad<CT>();
  static constexpr int QW = DH >= 128 ? 32 : 64;    // query columns of a score fragment
  static constexpr int MIN_BLOCKS = TK == 128 && DH <= 32 ? 2 : 1;  // <= 128 registers
  static constexpr size_t bytes = sizeof(CT) * (2 * TK + 4 * TR) * LD +
                                  4 * (4 * TR + NTH / 32 * 2 * scratch_floats<CT, QW / 8>());
};
static_assert(DkvTile<float, 128>::bytes <= 232448, "a block's shared memory on Hopper");
static_assert(DkvTile<tc::bf16, 128>::bytes <= 232448, "a block's shared memory on Hopper");

}  // namespace

template <typename T, typename CT, int DH>
__global__ void __launch_bounds__(DkvTile<CT, DH>::NTH, DkvTile<CT, DH>::MIN_BLOCKS)
    parallel_bw_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ b,
                           const float* __restrict__ li, const float* __restrict__ den,
                           const T* __restrict__ dh, T* __restrict__ dk, T* __restrict__ dv,
                           int S, float qk_scale, float eps) {
  using Tl = DkvTile<CT, DH>;
  constexpr int LD = Tl::LD, QW = Tl::QW, TK = Tl::TK, NTH = Tl::NTH;
  constexpr int NS = QW / 8;  // n-tiles of 8 queries in a score fragment
  constexpr int NJ = DH / 8;  // n-tiles of 8 columns of dk and dv
  constexpr bool RAW = std::is_same<T, CT>::value;  // dh staged unchanged, scaled in place
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CT* sk = reinterpret_cast<CT*>(smem_raw);  // (TK, LD) R(k) of the own keys
  CT* sv = sk + TK * LD;                     // (TK, LD) R(v) of the own keys
  CT* sq = sv + TK * LD;                     // 2 x (TR, LD) R(q) of a query tile
  CT* sn = sq + 2 * TR * LD;                 // 2 x (TR, LD) dh, then R(dhn)
  float* sbq = reinterpret_cast<float*>(sn + 2 * TR * LD);  // 2 x (TR) b of the queries
  float* sdq = sbq + 2 * TR;                                // 2 x (TR) den of the queries
  float* scratch = sdq + 2 * TR + threadIdx.x / 32 * 2 * scratch_floats<CT, NS>();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NQ = tiles(S);
  const int kt = heavy_first(blockIdx.y, (S + TK - 1) / TK, false);
  const size_t base = (size_t)blockIdx.x * S;
  const int k0 = kt * TK, j0 = 16 * warp;
  const int first = k0 / TR;         // the block's first query tile
  const int diag = (k0 + j0) / TR;   // the query tile of the warp's diagonal
  const T* qb = q + base * DH;
  const T* dhb = dh + base * DH;

  auto prefetch = [&](int qt, int buf) {
    const int q0 = qt * TR;
    stage_tile<T, CT, DH, LD, TR, NTH>(sq + buf * TR * LD, qb, q0, S);
    stage_tile<T, CT, DH, LD, TR, NTH>(sn + buf * TR * LD, dhb, q0, S,
                                       RAW ? nullptr : den + base, eps);
    for (int e = threadIdx.x; e < TR; e += NTH) {
      const bool ok = q0 + e < S;
      tc::cp_async4(sbq + buf * TR + e, ok ? b + base + q0 + e : b, ok);
      tc::cp_async4(sdq + buf * TR + e, ok ? den + base + q0 + e : den, ok);
    }
    tc::cp_async_commit();
  };
  stage_tile<T, CT, DH, LD, TK, NTH>(sk, k + base * DH, k0, S);
  stage_tile<T, CT, DH, LD, TK, NTH>(sv, v + base * DH, k0, S);
  prefetch(first, 0);

  // the gate rows of the warp's two keys of each lane (0 past S: those rows
  // are zero and never written)
  float bj[2], lj[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = k0 + j0 + g + 8 * hh;
    bj[hh] = j < S ? b[base + j] : 0.f;
    lj[hh] = j < S ? li[base + j] : 0.f;
  }
  float ak[NJ][4], av[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) ak[j][x] = av[j][x] = 0.f;

  walk_tiles(
      first, NQ - 1, prefetch,
      [&](int, int buf) {
        if constexpr (RAW) {  // the dh tile is in: R(dhn) in place
          scale_rows<CT, DH, LD, NTH>(sn + buf * TR * LD, sdq + buf * TR, eps);
          __syncthreads();
        }
      },
      [&](int qt, int buf) {
        if (qt < diag) return;  // every query of the tile precedes the warp's keys
        const int q0 = qt * TR;
        const float* cb = sbq + buf * TR;
        // the diagonal tile masks l < j, a ragged last tile l >= S, before the exp
        auto step = [&](auto masked) {
          dkv_step<DH, QW>(ak, av, sk, sv, j0, sq + buf * TR * LD, sn + buf * TR * LD, LD,
                           scratch, qk_scale, [&](int hh, int c) {
                             return decltype(masked)::value &&
                                            (q0 + c < k0 + j0 + g + 8 * hh || q0 + c >= S)
                                        ? -CUDART_INF_F
                                        : (cb[c] - bj[hh]) + lj[hh];
                           });
        };
        if (qt == diag || q0 + TR > S) step(std::true_type{});
        else step(std::false_type{});
      });

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = k0 + j0 + g + 8 * hh;
    if (j >= S) continue;
    const size_t off = (base + j) * DH + 2 * t;
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn) {
      tc::st2(dk + off + 8 * jn, ak[jn][2 * hh] * qk_scale, ak[jn][2 * hh + 1] * qk_scale);
      tc::st2(dv + off + 8 * jn, av[jn][2 * hh], av[jn][2 * hh + 1]);
    }
  }
}

// dtype, cdtype as in parallel_fw.  den: the forward's (B * NH, S) float32;
// dh (B * NH, S, DH) in the storage type.  Output dq in the storage type.
extern "C" int parallel_bw_dq(const void* k, const void* v, const float* b, const float* li,
                              const float* den, const void* dh, void* dq, int BNH, int S, int DH,
                              int dtype, int cdtype, float qk_scale, float eps, void* stream) {
  if (S <= 0 || BNH <= 0) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dhd) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dhd)::value;
    const size_t smem = DqSmem<CT, D>::bytes;
    cudaError_t err = port::allow_smem(parallel_bw_dq_kernel<T, CT, D>, smem);
    if (err != cudaSuccess) return (int)err;
    parallel_bw_dq_kernel<T, CT, D><<<dim3(BNH, tiles(S)), NTC, smem, st>>>(
        static_cast<const T*>(k), static_cast<const T*>(v), b, li, den,
        static_cast<const T*>(dh), static_cast<T*>(dq), S, qk_scale, eps);
    return (int)cudaGetLastError();
  });
}

// Outputs dk, dv (B * NH, S, DH) in the storage type.
extern "C" int parallel_bw_dkv(const void* q, const void* k, const void* v, const float* b,
                               const float* li, const float* den, const void* dh, void* dk,
                               void* dv, int BNH, int S, int DH, int dtype, int cdtype,
                               float qk_scale, float eps, void* stream) {
  if (S <= 0 || BNH <= 0) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dhd) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dhd)::value;
    using Tl = DkvTile<CT, D>;
    cudaError_t err = port::allow_smem(parallel_bw_dkv_kernel<T, CT, D>, Tl::bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(BNH, (S + Tl::TK - 1) / Tl::TK);
    parallel_bw_dkv_kernel<T, CT, D><<<grid, Tl::NTH, Tl::bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), b, li,
        den, static_cast<const T*>(dh), static_cast<T*>(dk), static_cast<T*>(dv), S, qk_scale,
        eps);
    return (int)cudaGetLastError();
  });
}
