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
// dQ (parallel_bw_dq_kernel): a block of 256 threads owns 64 query rows
// and walks the key tiles up to the diagonal through shared memory, the P
// tile in shared memory between the two products, as float32 FMA on the
// CUDA cores (parallel.cuh's tile_dot).
//
// dK/dV (parallel_bw_dkv_kernel), on the tensor cores: a block owns 128
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
// and dk without leaving the registers.  The trouble is registers: the dk
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

template <typename T, typename CT, int DH>
__global__ void __launch_bounds__(NT) parallel_bw_dq_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ b,
    const float* __restrict__ li, const float* __restrict__ den, const T* __restrict__ dh,
    T* __restrict__ dq, int S, float qk_scale, float eps) {
  constexpr int DP = DH + 1;
  constexpr int CPT = DH / 4;
  extern __shared__ float smem[];  // qtile_smem_floats<DH>()
  float* sdn = smem;            // (TR, DP) R(dh / (den + eps)) of the query rows
  float* sv = sdn + TR * DP;    // (TR, DP) R(v) of the key tile
  float* sk = sv + TR * DP;     // (TR, DP) R(k) of the key tile
  float* sp = sk + TR * DP;     // (TR, TP) P
  float* sbq = sp + TR * TP;    // (TR) b of the query rows
  float* sbk = sbq + TR;        // (TR) b of the key rows
  float* slk = sbk + TR;        // (TR) logsig(i) of the key rows

  const int tid = threadIdx.x;
  const int qt = heavy_first(blockIdx.x, tiles(S), true);
  const size_t base = (size_t)blockIdx.y * S;
  const int q0 = qt * TR;
  load_tile<T, CT, DH>(dh + base * DH, den + base, eps, q0, S, sdn);
  load_rows(b + base, q0, S, sbq);

  const int ti = tid / 16, tj = tid % 16;
  const int row = tid / 4, cc = (tid % 4) * CPT;
  float acc_q[CPT];
#pragma unroll
  for (int x = 0; x < CPT; ++x) acc_q[x] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * TR;
    __syncthreads();
    load_tile<T, CT, DH>(v + base * DH, nullptr, 0.f, k0, S, sv);
    load_tile<T, CT, DH>(k + base * DH, nullptr, 0.f, k0, S, sk);
    load_rows(b + base, k0, S, sbk);
    load_rows(li + base, k0, S, slk);
    __syncthreads();
    float acc[4][4];
    tile_dot<DH>(sdn, sv, ti, tj, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lr = ti * 4 + r;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int jr = tj * 4 + s;
        sp[lr * TP + jr] = acc[r][s] * decay(q0 + lr, k0 + jr, S, sbq[lr], sbk[jr], slk[jr]);
      }
    }
    __syncthreads();
    for (int j = 0; j < TR; ++j) {
      const float p = rt<CT>(sp[row * TP + j]);
#pragma unroll
      for (int x = 0; x < CPT; ++x) acc_q[x] = fmaf(p, sk[j * DP + cc + x], acc_q[x]);
    }
  }

  const int l = q0 + row;
  if (l < S) {
#pragma unroll
    for (int x = 0; x < CPT; ++x) from_f32(acc_q[x] * qk_scale, dq + (base + l) * DH + cc + x);
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

  for (int qt = first; qt < NQ; ++qt) {
    const int buf = (qt - first) & 1, q0 = qt * TR;
    const CT* cq = sq + buf * TR * LD;
    CT* cn = sn + buf * TR * LD;
    const float* cb = sbq + buf * TR;
    tc::cp_async_wait<0>();
    __syncthreads();  // query tile qt is in; every warp is done with tile qt - 1
    if constexpr (RAW) {
      scale_rows<CT, DH, LD, NTH>(cn, sdq + buf * TR, eps);
      __syncthreads();
    }
    if (qt + 1 < NQ) prefetch(qt + 1, buf ^ 1);
    if (qt < diag) continue;  // every query of the tile precedes the warp's keys

    // the diagonal tile masks l < j, a ragged last tile l >= S, before the exp
    auto walk = [&](auto masked) {
#pragma unroll 1  // one QW step's fragments live at a time (DH 128: registers)
      for (int qo = 0; qo < TR; qo += QW) {
        float st[NS][4], pt[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) st[n][x] = pt[n][x] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          tc::prod16<NS, false, false>(st, sk, LD, j0, cq, LD, qo, 16 * kk);  // k . q
          tc::prod16<NS, false, false>(pt, sv, LD, j0, cn, LD, qo, 16 * kk);  // v . dhn
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const int l = qo + 8 * n + 2 * t;
          const float2 bl = *reinterpret_cast<const float2*>(cb + l);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int hh = x >> 1, e = x & 1;
            float ex = ((e ? bl.y : bl.x) - bj[hh]) + lj[hh];
            if (decltype(masked)::value &&
                (q0 + l + e < k0 + j0 + g + 8 * hh || q0 + l + e >= S))
              ex = -CUDART_INF_F;
            const float d = __expf(ex);
            st[n][x] = (st[n][x] * qk_scale) * d;
            pt[n][x] *= d;
          }
        }
        score_times<NS, NJ>(av, st, scratch, cn + qo * LD, LD);  // dv += R(S D)^T R(dhn)
        score_times<NS, NJ>(ak, pt, scratch + scratch_floats<CT, NS>(), cq + qo * LD, LD);
      }
    };
    if (qt == diag || q0 + TR > S) walk(std::true_type{});
    else walk(std::false_type{});
  }

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
    return launch_with_smem(parallel_bw_dq_kernel<T, CT, D>, dim3(tiles(S), BNH),
                            sizeof(float) * qtile_smem_floats<D>(), st, static_cast<const T*>(k),
                            static_cast<const T*>(v), b, li, den, static_cast<const T*>(dh),
                            static_cast<T*>(dq), S, qk_scale, eps);
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
