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
// the TPU kernel casts (`:68, :74`); sums are float32, each in a fixed
// order (j ascending).
//
// Design.  The TPU kernel keeps all of K and V of a (batch, head) in VMEM
// and makes one (TQ x S) score tile per grid step.  Hopper's shared memory
// holds 227 KB, and an (S x S) row block of S = 6656 does not fit, so a
// block owns 64 query rows and walks the 64-row key tiles up to its
// diagonal, staging R(k), R(v) and the key gate rows in shared memory and
// the (64 x 64) sd tile between the two products; h and den accumulate in
// registers.  Products are float32 FMA on the CUDA cores (no tensor cores
// yet).
//
// What bounds it.  The function reads q, k, v once and writes h and den:
// 171 MB at the flagship's S = 6656 (B 8, NH 12, DH 32, bf16), 51 us at
// 3.35 TB/s; its causal products are 2 S^2 DH B NH flop, 272 GFLOP, 275 us
// at the bf16 tensor-core peak.  So it is bound by operations at the long
// sequences; this version's float32 FMA runs far above that bound, and
// PERF.md holds its times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "parallel.cuh"

using namespace par;

template <typename T, typename CT, int DH>
__global__ void __launch_bounds__(NT) parallel_fw_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ b, const float* __restrict__ li, T* __restrict__ h,
    float* __restrict__ den_out, int S, float qk_scale, float eps) {
  constexpr int DP = DH + 1;
  constexpr int CPT = DH / 4;  // output columns per thread, 4 threads per row
  extern __shared__ float smem[];  // qtile_smem_floats<DH>()
  float* sq = smem;             // (TR, DP) R(q)
  float* sk = sq + TR * DP;     // (TR, DP) R(k) of the key tile
  float* sv = sk + TR * DP;     // (TR, DP) R(v) of the key tile
  float* ssd = sv + TR * DP;    // (TR, TP) R(q) R(k)^T scale * D
  float* sbq = ssd + TR * TP;   // (TR) b of the query rows
  float* sbk = sbq + TR;        // (TR) b of the key rows
  float* slk = sbk + TR;        // (TR) logsig(i) of the key rows

  const int tid = threadIdx.x;
  const int qt = heavy_first(blockIdx.x, tiles(S), true);
  const size_t base = (size_t)blockIdx.y * S;  // first row of this (batch, head)
  const int q0 = qt * TR;
  load_tile<T, CT, DH>(q + base * DH, nullptr, 0.f, q0, S, sq);
  load_rows(b + base, q0, S, sbq);

  const int ti = tid / 16, tj = tid % 16;  // 4 x 4 piece of the score tile
  const int row = tid / 4, cc = (tid % 4) * CPT;
  float num[CPT];
#pragma unroll
  for (int x = 0; x < CPT; ++x) num[x] = 0.f;
  float n = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * TR;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, CT, DH>(k + base * DH, nullptr, 0.f, k0, S, sk);
    load_tile<T, CT, DH>(v + base * DH, nullptr, 0.f, k0, S, sv);
    load_rows(b + base, k0, S, sbk);
    load_rows(li + base, k0, S, slk);
    __syncthreads();
    float acc[4][4];
    tile_dot<DH>(sq, sk, ti, tj, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lr = ti * 4 + r;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int jr = tj * 4 + s;
        ssd[lr * TP + jr] =
            (acc[r][s] * qk_scale) * decay(q0 + lr, k0 + jr, S, sbq[lr], sbk[jr], slk[jr]);
      }
    }
    __syncthreads();
    for (int j = 0; j < TR; ++j) {
      const float s = ssd[row * TP + j];
      n += s;
      const float sr = rt<CT>(s);
#pragma unroll
      for (int x = 0; x < CPT; ++x) num[x] = fmaf(sr, sv[j * DP + cc + x], num[x]);
    }
  }

  const int l = q0 + row;
  if (l < S) {
    const float den = fmaxf(fabsf(n), 1.f);
    if (cc == 0) den_out[base + l] = den;
    const float inv = den + eps;
#pragma unroll
    for (int x = 0; x < CPT; ++x) from_f32(num[x] / inv, h + (base + l) * DH + cc + x);
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
    return launch_with_smem(parallel_fw_kernel<T, CT, D>, dim3(tiles(S), BNH),
                            sizeof(float) * qtile_smem_floats<D>(), st, static_cast<const T*>(q),
                            static_cast<const T*>(k), static_cast<const T*>(v), b, li,
                            static_cast<T*>(h), den, S, qk_scale, eps);
  });
}
