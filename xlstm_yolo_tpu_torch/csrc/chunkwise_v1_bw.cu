// Chunkwise sigmoid-input-gate mLSTM backward, the v1 route, for Hopper,
// sm_90a: two kernels, as on the TPU.
//
// Replaces the TPU kernels `_bw_dc_kernel` (xlstm_yolo_tpu/ops/pallas/
// chunkwise.py:271, call :431) and `_bw_dqkv_kernel` (:316, call :463),
// both launched by `_bw` :397.  The denominator den = max(|.|, 1) saved by
// the forward is a constant, as in the Pallas VJP.  With dhn = dh / (den +
// eps), qbar = q e^b scale, D = tril(e^{b_l - b_j + logsig(i_j)}) and R()
// the rounding to the compute type at the TPU kernels' casts (`:305, 342,
// 348, 359, 364, 372, 377, 385, 390`):
//
//   chunkwise_v1_bw_dc:   dC_{k-1} = e^g dC_k + R(qbar_k)^T R(dhn_k), walking
//                         the chunks in reverse from dC_last (or zeros);
//                         dc_states[k] = dC_k, the gradient of the state
//                         after chunk k, and dc0 = dC_{-1};
//   chunkwise_v1_bw_dqkv: per chunk, from c_states[k] = C_{k-1} and dC_k,
//                         P  = (R(dhn) R(v)^T) * D,  SD = (R(q) R(k)^T scale) * D
//                         dq = R(P) R(k) scale + (R(dhn) R(C_{k-1})^T) e^b scale
//                         dk = R(P)^T R(q) scale + (R(v) R(dC_k)^T) e^a
//                         dv = R(SD)^T R(dhn) + R(k e^a) R(dC_k)
//
// in float32; the wrapper computes the gate gradients from dq and dk and
// casts them, as `_bw` does.
//
// Design.  The dC scan is the serial part: state_scan_kernel
// (chunkwise_v1.cuh), one block per (batch, head), a (L x DH)^T (L x DH)
// product per chunk.  The dq/dk/dv kernel is independent per (batch * head,
// chunk): every (batch * head, chunk, 64-row sub-tile, part) is a block,
// part 0 computing dq of the sub-tile's rows (walking the key sub-tiles at
// or before it) and part 1 dk and dv of its rows as keys (walking the query
// sub-tiles at or after it), so a chunk of 512 rows needs no (512 x 512)
// tile in shared memory.  2 * 96 * S / 64 blocks at batch 8 fill the card.
// Products are float32 FMA on the CUDA cores with rounded operands.
//
// What bounds it.  The pair moves q, k, v, dh, dq, dk, dv once, the gates,
// den and the states per chunk: bound by bytes (PERF.md).  This first
// version recomputes the (L x L) tiles in float32 FMA, whose work grows
// with L; PERF.md holds its times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "chunkwise_v1.cuh"

namespace {

using namespace v1;

template <int DH>
constexpr size_t dqkv_smem_floats() {
  return 2 * LMAX                 // b, logsig(i)
         + 5 * TR * (DH + 1)      // own-tile operands (3), other-tile operands (2)
         + DH * (DH + 1)          // R(C_prev) or R(dC)
         + 2 * TR * (TR + 1);     // P, SD tiles
}

template <typename T, typename CT, int DH>
__global__ void __launch_bounds__(NT) dqkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg,
    const float* __restrict__ c_states, const float* __restrict__ den, const T* __restrict__ dh,
    const float* __restrict__ dc_states, float* __restrict__ dq, float* __restrict__ dk,
    float* __restrict__ dv, int S, int L, float qk_scale, float eps) {
  constexpr int DP = DH + 1;
  constexpr int TP = TR + 1;
  constexpr int CPT = DH / 4;
  extern __shared__ float smem[];
  float* sb = smem;
  float* sli = sb + LMAX;
  float* sA = sli + LMAX;      // own rows: R(dhn) (dq) | R(k) (dk, dv)
  float* sB = sA + TR * DP;    // own rows: unused    | R(v)
  float* sKa = sB + TR * DP;   // own rows: unused    | R(k e^a)
  float* sX = sKa + TR * DP;   // other rows: R(v)    | R(q)
  float* sY = sX + TR * DP;    // other rows: R(k)    | R(dhn)
  float* sS = sY + TR * DP;    // (DH, DP) R(C_prev)  | R(dC)
  float* sP = sS + DH * DP;    // (TR, TP) P
  float* sSD = sP + TR * TP;   // (TR, TP) SD (dk, dv only)

  const int tid = threadIdx.x;
  const int T_ = tile_rows(L);
  const int tiles = L / T_;
  const int c = blockIdx.x / tiles, st = blockIdx.x - c * tiles;
  const int bh = blockIdx.y;
  const bool part_q = blockIdx.z == 0;
  const int NC = S / L;
  const size_t t0 = (size_t)bh * S + (size_t)c * L;
  const size_t slot = (size_t)bh * NC + c;
  const int o0 = st * T_;  // chunk row of the block's own first row

  chunk_gates(ig + t0, fg + t0, L, sb, sli);
  const float* state = part_q ? c_states : dc_states;
  for (int e = tid; e < DH * DH; e += NT)
    sS[(e / DH) * DP + e % DH] = rt<CT>(state[slot * DH * DH + e]);
  __syncthreads();
  const float g = sb[L - 1];
  for (int e = tid; e < T_ * DH; e += NT) {
    const int r = e / DH, d = e - r * DH;
    const size_t row = t0 + o0 + r;
    if (part_q) {
      sA[r * DP + d] = rt<CT>(to_f32(dh[row * DH + d]) / (den[row] + eps));
    } else {
      const float kx = to_f32(k[row * DH + d]);
      sA[r * DP + d] = rt<CT>(kx);
      sB[r * DP + d] = rt<CT>(to_f32(v[row * DH + d]));
      sKa[r * DP + d] = rt<CT>(kx * expf((g - sb[o0 + r]) + sli[o0 + r]));
    }
  }
  __syncthreads();

  const int row = tid / 4, cc = (tid % 4) * CPT;
  const bool has_row = row < T_;
  float a1[CPT], a2[CPT], i1[CPT], i2[CPT];
#pragma unroll
  for (int x = 0; x < CPT; ++x) a1[x] = a2[x] = i1[x] = i2[x] = 0.f;
  if (has_row) {  // inter-chunk parts
#pragma unroll 4
    for (int u = 0; u < DH; ++u) {
      if (part_q) {  // R(dhn) R(C_prev)^T
        const float dn = sA[row * DP + u];
#pragma unroll
        for (int x = 0; x < CPT; ++x) i1[x] = fmaf(dn, sS[(cc + x) * DP + u], i1[x]);
      } else {  // R(v) R(dC)^T and R(k e^a) R(dC)
        const float vu = sB[row * DP + u], ku = sKa[row * DP + u];
#pragma unroll
        for (int x = 0; x < CPT; ++x) {
          i1[x] = fmaf(vu, sS[(cc + x) * DP + u], i1[x]);
          i2[x] = fmaf(ku, sS[u * DP + cc + x], i2[x]);
        }
      }
    }
  }

  const int TT = T_ / 4;
  const int first = part_q ? 0 : st, last = part_q ? st : tiles - 1;
  for (int ot = first; ot <= last; ++ot) {
    const int p0 = ot * T_;  // chunk row of the other sub-tile
    for (int e = tid; e < T_ * DH; e += NT) {
      const int r = e / DH, d = e - r * DH;
      const size_t rr = t0 + p0 + r;
      if (part_q) {
        sX[r * DP + d] = rt<CT>(to_f32(v[rr * DH + d]));
        sY[r * DP + d] = rt<CT>(to_f32(k[rr * DH + d]));
      } else {
        sX[r * DP + d] = rt<CT>(to_f32(q[rr * DH + d]));
        sY[r * DP + d] = rt<CT>(to_f32(dh[rr * DH + d]) / (den[rr] + eps));
      }
    }
    __syncthreads();
    if (tid < TT * TT) {
      // tile rows are queries l, columns keys j: for dq the queries are the
      // own rows (P = sA sX^T); for dk, dv the keys are (P = sY sB^T,
      // SD = sX sA^T scale)
      const int ti = tid / TT, tj = tid % TT;
      const float* Lp = part_q ? sA : sY;  // query-side operand of P
      const float* Rp = part_q ? sX : sB;  // key-side operand of P
      float ap[4][4] = {}, as[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float la[4], rb[4], qa[4], kb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          la[r] = Lp[(ti * 4 + r) * DP + d];
          rb[r] = Rp[(tj * 4 + r) * DP + d];
          qa[r] = part_q ? 0.f : sX[(ti * 4 + r) * DP + d];
          kb[r] = part_q ? 0.f : sA[(tj * 4 + r) * DP + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            ap[r][s] = fmaf(la[r], rb[s], ap[r][s]);
            as[r][s] = fmaf(qa[r], kb[s], as[r][s]);
          }
      }
      const int lq0 = part_q ? o0 : p0, lk0 = part_q ? p0 : o0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = lq0 + ti * 4 + r;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = lk0 + tj * 4 + s;
          // the exponent is masked before exp: b_l - b_j > 0 above the diagonal
          const float dm = j <= l ? expf(sb[l] - sb[j] + sli[j]) : 0.f;
          sP[(ti * 4 + r) * TP + tj * 4 + s] = ap[r][s] * dm;
          sSD[(ti * 4 + r) * TP + tj * 4 + s] = (as[r][s] * qk_scale) * dm;
        }
      }
    }
    __syncthreads();
    if (has_row) {
      if (part_q) {  // dq: sum_j R(P[row, j]) R(k_j)
        for (int j = 0; j < T_; ++j) {
          const float p = rt<CT>(sP[row * TP + j]);
#pragma unroll
          for (int x = 0; x < CPT; ++x) a1[x] = fmaf(p, sY[j * DP + cc + x], a1[x]);
        }
      } else {  // dk: sum_l R(P[l, row]) R(q_l); dv: sum_l R(SD[l, row]) R(dhn_l)
        for (int l = 0; l < T_; ++l) {
          const float p = rt<CT>(sP[l * TP + row]);
          const float s = rt<CT>(sSD[l * TP + row]);
#pragma unroll
          for (int x = 0; x < CPT; ++x) {
            a1[x] = fmaf(p, sX[l * DP + cc + x], a1[x]);
            a2[x] = fmaf(s, sY[l * DP + cc + x], a2[x]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (has_row) {
    const int l = o0 + row;
    const size_t off = (t0 + l) * DH + cc;
    if (part_q) {
      const float eb = expf(sb[l]) * qk_scale;
#pragma unroll
      for (int x = 0; x < CPT; ++x) dq[off + x] = a1[x] * qk_scale + i1[x] * eb;
    } else {
      const float ea = expf((g - sb[l]) + sli[l]);
#pragma unroll
      for (int x = 0; x < CPT; ++x) {
        dk[off + x] = a1[x] * qk_scale + i1[x] * ea;
        dv[off + x] = a2[x] + i2[x];
      }
    }
  }
}

}  // namespace

// dtype, cdtype: 0 = float32, 1 = bfloat16 (storage of q and dh; compute
// type of the products).  den (B, NH, S) from chunkwise_v1_fw; dc_last
// (B, NH, DH, DH) may be null.  Outputs dc_states (B, NH, NC, DH, DH) and
// dc0 (B, NH, DH, DH) float32.  Returns a CUDA error code; 1000 for a
// dtype, head size or chunk the kernels do not take.
extern "C" int chunkwise_v1_bw_dc(const void* q, const float* f, const void* dh,
                                  const float* den, const float* dc_last, float* dc_states,
                                  float* dc0, int B, int NH, int S, int DH, int L, int dtype,
                                  int cdtype, float qk_scale, float eps, void* stream) {
  if (!chunk_ok(S, L)) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dhd) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dhd)::value;
    state_scan_kernel<T, CT, D, true><<<B * NH, NT, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(dh), nullptr, f, den, dc_last, nullptr,
        dc_states, nullptr, dc0, nullptr, S, L, qk_scale, eps);
    return (int)cudaGetLastError();
  });
}

// The same types; c_states from chunkwise_v1_fw, dc_states from
// chunkwise_v1_bw_dc.  Outputs dq, dk, dv (B, NH, S, DH) float32.
extern "C" int chunkwise_v1_bw_dqkv(const void* q, const void* k, const void* v, const float* i,
                                    const float* f, const float* c_states, const float* den,
                                    const void* dh, const float* dc_states, float* dq, float* dk,
                                    float* dv, int B, int NH, int S, int DH, int L, int dtype,
                                    int cdtype, float qk_scale, float eps, void* stream) {
  if (!chunk_ok(S, L)) return 1000;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dhd) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dhd)::value;
    const size_t smem = sizeof(float) * dqkv_smem_floats<D>();
    cudaError_t err = cudaFuncSetAttribute(
        dqkv_kernel<T, CT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S / L) * (L / tile_rows(L)), B * NH, 2);
    dqkv_kernel<T, CT, D><<<grid, NT, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), i, f,
        c_states, den, static_cast<const T*>(dh), dc_states, dq, dk, dv, S, L, qk_scale, eps);
    return (int)cudaGetLastError();
  });
}
