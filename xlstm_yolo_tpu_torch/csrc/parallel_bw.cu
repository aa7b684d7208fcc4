// Quadratic (parallel) sigmoid-input-gate mLSTM backward for Hopper, sm_90a:
// two kernels, as on the TPU.
//
// Replaces `_bw_dq_kernel` (xlstm_yolo_tpu/ops/pallas/parallel.py:84, call
// :256) and `_bw_dkv_kernel` (:117, call :277), launched by `_core_bwd`
// :235.  The denominator is held constant (the TPU VJP's semantics): with
// dhn_l = dh_l / (den_l + eps), D as in parallel.cuh,
//
//   dQ:    P[l, j] = (R(dhn_l) . R(v_j)) D[l, j],   dq_l = sum_j R(P[l, j]) R(k_j) scale
//   dK/dV: dk_j = sum_l R(P[l, j]) R(q_l) scale,
//          dv_j = sum_l R((R(k_j) . R(q_l)) scale D[l, j]) R(dhn_l)
//
// each written in the storage type, as the TPU kernels write dq in q's
// dtype and dk, dv in k's and v's.  R() rounds to the compute type where
// the TPU kernels cast (`:105-111, :140-163`); sums are float32 in a fixed
// order.  The gate gradients are taken outside, in PyTorch, from these.
//
// Design.  The TPU kernels keep all of K, V (dQ) or of Q, dh (dK/dV) of a
// (batch, head) in VMEM.  Here a block owns 64 rows and walks the 64-row
// tiles across the diagonal through shared memory: dQ over query tiles,
// walking the key tiles up to the diagonal; dK/dV over key tiles, walking
// the query tiles from the diagonal on (the column-causal walk), both P and
// the (S * D) tile of a step in shared memory.  Every output row is written
// by one block: no atomics, and the result does not depend on the order in
// which blocks run.  The tile length does not change the numbers: every
// sum runs over the same terms in the same ascending order.
//
// What bounds it.  dQ reads k, v, dh and den and writes dq; dK/dV reads q,
// k, v, dh and den and writes dk and dv (both also read the gate rows):
// 171 MB and 253 MB at the flagship's S = 6656 (B 8, NH 12, DH 32, bf16).  Their causal
// products are 2 and 4 S^2 DH B NH flop (272 and 544 GFLOP, 275 and 550 us
// at the bf16 tensor-core peak), so both are bound by operations at the long
// sequences.  This version's float32 FMA runs far above that bound, and
// PERF.md holds its times.

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

template <int DH>
constexpr size_t dkv_smem_floats() {
  return 4 * TR * (DH + 1)  // own R(k), R(v); the query tile's R(q), R(dhn)
         + 2 * TR * TP      // P and the (S * D) tile
         + 3 * TR;          // b, logsig(i) of the own keys, b of the query tile
}

template <typename T, typename CT, int DH>
__global__ void __launch_bounds__(NT) parallel_bw_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ b, const float* __restrict__ li, const float* __restrict__ den,
    const T* __restrict__ dh, T* __restrict__ dk, T* __restrict__ dv, int S, float qk_scale,
    float eps) {
  constexpr int DP = DH + 1;
  constexpr int CPT = DH / 4;
  extern __shared__ float smem[];
  float* sk = smem;           // (TR, DP) own keys R(k)
  float* sv = sk + TR * DP;   // (TR, DP) own keys R(v)
  float* sq = sv + TR * DP;   // (TR, DP) query tile R(q)
  float* sdn = sq + TR * DP;  // (TR, DP) query tile R(dh / (den + eps))
  float* sp = sdn + TR * DP;  // (TR, TP) P[l, j]
  float* ssd = sp + TR * TP;  // (TR, TP) (S * D)[l, j]
  float* sbk = ssd + TR * TP;
  float* slk = sbk + TR;
  float* sbq = slk + TR;

  const int tid = threadIdx.x;
  const int NQ = tiles(S);
  const int kt = heavy_first(blockIdx.x, NQ, false);
  const size_t base = (size_t)blockIdx.y * S;
  const int k0 = kt * TR;
  load_tile<T, CT, DH>(k + base * DH, nullptr, 0.f, k0, S, sk);
  load_tile<T, CT, DH>(v + base * DH, nullptr, 0.f, k0, S, sv);
  load_rows(b + base, k0, S, sbk);
  load_rows(li + base, k0, S, slk);

  const int ti = tid / 16, tj = tid % 16;  // ti: query rows, tj: key rows of a tile
  const int row = tid / 4, cc = (tid % 4) * CPT;  // row: an own key
  float acc_k[CPT], acc_v[CPT];
#pragma unroll
  for (int x = 0; x < CPT; ++x) acc_k[x] = acc_v[x] = 0.f;

  for (int qt = kt; qt < NQ; ++qt) {
    const int q0 = qt * TR;
    __syncthreads();
    load_tile<T, CT, DH>(q + base * DH, nullptr, 0.f, q0, S, sq);
    load_tile<T, CT, DH>(dh + base * DH, den + base, eps, q0, S, sdn);
    load_rows(b + base, q0, S, sbq);
    __syncthreads();
    float ap[4][4], as[4][4];
    tile_dot<DH>(sdn, sv, ti, tj, ap);  // dhn_l . v_j
    tile_dot<DH>(sq, sk, ti, tj, as);   // q_l . k_j
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lr = ti * 4 + r;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int jr = tj * 4 + s;
        const float dm = decay(q0 + lr, k0 + jr, S, sbq[lr], sbk[jr], slk[jr]);
        sp[lr * TP + jr] = ap[r][s] * dm;
        ssd[lr * TP + jr] = (as[r][s] * qk_scale) * dm;
      }
    }
    __syncthreads();
    for (int l = 0; l < TR; ++l) {
      const float p = rt<CT>(sp[l * TP + row]);
      const float s = rt<CT>(ssd[l * TP + row]);
#pragma unroll
      for (int x = 0; x < CPT; ++x) {
        acc_k[x] = fmaf(p, sq[l * DP + cc + x], acc_k[x]);
        acc_v[x] = fmaf(s, sdn[l * DP + cc + x], acc_v[x]);
      }
    }
  }

  const int j = k0 + row;
  if (j < S) {
    const size_t off = (base + j) * DH + cc;
#pragma unroll
    for (int x = 0; x < CPT; ++x) {
      from_f32(acc_k[x] * qk_scale, dk + off + x);
      from_f32(acc_v[x], dv + off + x);
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
    return launch_with_smem(parallel_bw_dkv_kernel<T, CT, D>, dim3(tiles(S), BNH),
                            sizeof(float) * dkv_smem_floats<D>(), st, static_cast<const T*>(q),
                            static_cast<const T*>(k), static_cast<const T*>(v), b, li, den,
                            static_cast<const T*>(dh), static_cast<T*>(dk), static_cast<T*>(dv),
                            S, qk_scale, eps);
  });
}
