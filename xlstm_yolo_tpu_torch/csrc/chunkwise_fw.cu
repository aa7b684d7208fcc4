// Chunkwise sigmoid-input-gate mLSTM forward for Hopper, sm_90a: inference,
// train and inference-with-LayerNorm variants.
//
// Replaces the TPU kernels `_fw_kernel_infer` (xlstm_yolo_tpu/ops/pallas/
// chunkwise_v2.py:245), `_fw_kernel_train` (:238) and `_fw_kernel_infer_ln`
// (:252), body `_fw_body` :130, and the host-side gate packing
// `_pack_gates` (:259).  The LN variant normalises each row's float32 h of
// each head before it is rounded (`_fw_body` :209-216): mean and centred
// variance over DH, (h - mean) rsqrt(var + ln_eps) lnw + lnb, with lnw the
// caller's (1 + w) and lnb (H,) float32.  The train variant
// (SAVE) also stores, for the backward, the state before each chunk,
// C (B, NC, NH, DH, DH) and n (B, NC, NH, DH), and the denominator
// max(|n_inter + n_intra|, 1) of each row, den (B, NC, NH, L), in float32
// (1 on rows past S).  C and n already live in shared memory, so each
// chunk's state is one extra store: 39 MB per call at B = 8, S = 6400.  It computes what that kernel computes, with
// the math of the plain version in xlstm_yolo_tpu_torch/ops/mlstm_chunkwise.py:
//
//   b = within-chunk cumsum of logsig(f),  a = (b_last - b) + logsig(i),
//   g = b_last,
//   C <- e^g C + (e^a * k)^T v,   n <- e^g n + sum_l e^a_l k_l,
//   D = tril(e^{b_l - b_j + logsig(i_j)}),
//   h = (e^b q~ C + (q~ k^T * D) v) / (max(|e^b q~ n + rowsum(q~ k^T * D)|, 1) + eps),
//   q~ = q * qk_scale.
//
// Layout.  q, k, v and h are (B, S, NH*DH), the model's own layout: a head
// is a DH-wide column slice of each row, so no head transposes are made.
// i and f are (B, S, NH) float32.  The last states are (B, NH, DH, DH) and
// (B, NH, DH) float32.  Ragged S is masked in the kernel: rows past S are
// zero-loaded (never read out of range) and their gates are made inert
// (logsig f = 0, logsig i = -inf); nothing is padded in device memory.
//
// Design.  One block of 256 threads per (batch, head) walks the chunks of
// L = 64 rows in order and keeps C and n in shared memory.  Gate prep (the
// logsig and the within-chunk cumsum, which the TPU kernel left to XLA for
// want of a cumsum in Mosaic) is one warp-shuffle scan over the chunk's
// rows.  Each chunk: load the q/k/v tiles with 16-byte loads (f32 in shared
// memory, q pre-scaled), build the causal q k^T * D tile (4x4 register
// tiles), form h = inter + intra for 8 columns of one row per thread, then
// update C and n.  All arithmetic is float32 FMA; bf16 inputs are widened on
// load, h is rounded once on store.  In the LN variant the 4 threads of a
// row (4 consecutive lanes) reduce its mean and then its centred variance
// with two rounds of __shfl_xor_sync each, before the store.
//
// Shared memory (dynamic, FwSmem): 4 (2 DH (L + 4) + L DH + L (L + 1) +
// DH^2 + DH + 4 L + 1) bytes, 47.5 KB at DH = 32, 85.5 KB at 64 and
// 186.1 KB at 128 (vil-det-384), one block per SM there.  Registers grow
// with DH: the state update holds DH^2 / 256 floats a thread (64 at DH =
// 128) and the h phase DH / 4 (32).
//
// What bounds it.  The function is memory-bound by a wide margin (about 46
// FLOP per byte moved at DH = 32, L = 64 in bf16, against the card's ~295
// for bf16 tensor-core work).  This first version does not reach that
// bound.  Occupancy: the grid has only B*NH blocks, 96 at batch 8 on 132
// SMs, one block of 8 warps per SM, so 36 SMs idle (at vil-det-384, NH = 6,
// 48 blocks: 84 idle) and each busy SM runs 8 of its 64 warp slots.
// Each block walks S/L chunks serially (100 at S = 6400) with float32 FMA
// and a __syncthreads between phases, and its global loads are not
// overlapped with compute: it is bound by the latency of that serial chain.
// On an H100 80GB HBM3 at 700 W it takes about 0.97 ms at B = 8,
// S = 6400 in bf16 against a 0.049 ms memory bound (PERF.md).  The faster
// design (a recurrent C-state kernel plus a chunk-parallel kernel on
// tensor cores, which fills the card) is left to a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using port::from_f32;
using port::to_f32;

constexpr int L = 64;     // chunk rows
constexpr int NT = 256;   // threads per block
constexpr int LP = L + 4; // padded row length of the transposed q/k tiles

enum Variant { INFER = 0, TRAIN = 1, INFER_LN = 2 };

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Load VE = 16 / sizeof(T) consecutive elements with one 16-byte access.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  constexpr int VE = 16 / sizeof(T);
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < VE; ++j) out[j] = to_f32(e[j]);
}

// Store N values as T, 16 bytes at a time when the row piece allows it.
template <typename T, int N>
__device__ __forceinline__ void store_row(T* p, const float* x) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES % 16 == 0) {
    constexpr int VE = 16 / sizeof(T);
#pragma unroll
    for (int w = 0; w < N / VE; ++w) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VE; ++j) from_f32(x[w * VE + j], e + j);
      *reinterpret_cast<uint4*>(p + w * VE) = raw;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) from_f32(x[j], p + j);
  }
}

// The block's shared memory.  Row lengths are multiples of 16 bytes, so
// the float4 reads below stay aligned.
template <int DH>
struct __align__(16) FwSmem {
  float sqT[DH][LP];  // q~ transposed
  float skT[DH][LP];  // k transposed
  float sv[L][DH];
  float ssd[L][L + 1];  // causal q~ k^T * D
  float sc[DH][DH];     // C state
  float sn[DH];         // n state
  float sb[L], seb[L], sea[L], sli[L];
  float sg;
};

// Sum of x over the 4 consecutive lanes of a row.
__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int DH, int VAR>
__global__ void __launch_bounds__(NT) chunkwise_fw_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg,
    const float* __restrict__ c0, const float* __restrict__ n0,
    T* __restrict__ h, float* __restrict__ c_last, float* __restrict__ n_last,
    float* __restrict__ c_states, float* __restrict__ n_states, float* __restrict__ den_out,
    const float* __restrict__ lnw, const float* __restrict__ lnb, int S, int NH,
    float qk_scale, float eps, float ln_eps) {
  constexpr bool SAVE = VAR == TRAIN;
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = DH / VE;        // 16-byte loads per head row
  constexpr int CPT = DH / 4;         // h columns per thread (4 threads per row)
  constexpr int TPR = NT / DH;        // threads per C row in the state update
  constexpr int VPT = DH / TPR;       // C columns per thread

  extern __shared__ __align__(16) unsigned char fw_smem[];
  FwSmem<DH>& sm = *reinterpret_cast<FwSmem<DH>*>(fw_smem);
  auto& sqT = sm.sqT;
  auto& skT = sm.skT;
  auto& sv = sm.sv;
  auto& ssd = sm.ssd;
  auto& sc = sm.sc;
  float* sn = sm.sn;
  float* sb = sm.sb;
  float* seb = sm.seb;
  float* sea = sm.sea;
  float* sli = sm.sli;
  float& sg = sm.sg;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / NH;
  const int hd = bh - b * NH;
  const int H = NH * DH;
  const size_t row0 = (size_t)b * S * H + (size_t)hd * DH;  // (b, s=0, head col 0)
  const size_t gate0 = (size_t)b * S * NH + hd;
  const size_t cst0 = (size_t)bh * DH * DH;

  for (int e = tid; e < DH * DH; e += NT) sc[e / DH][e % DH] = c0 ? c0[cst0 + e] : 0.f;
  if (tid < DH) sn[tid] = n0 ? n0[(size_t)bh * DH + tid] : 0.f;

  const int NC = (S + L - 1) / L;
  for (int c = 0; c < NC; ++c) {
    const int t0 = c * L;
    const size_t chunk_bh = ((size_t)b * NC + c) * NH + hd;  // (b, c, head)
    if constexpr (SAVE) {  // the state before this chunk
      for (int e = tid; e < DH * DH; e += NT) c_states[chunk_bh * DH * DH + e] = sc[e / DH][e % DH];
      if (tid < DH) n_states[chunk_bh * DH + tid] = sn[tid];
    }

    // 1. tiles: 16-byte loads of each head row, out-of-range rows zeroed
    for (int e = tid; e < L * VPR; e += NT) {
      const int r = e / VPR;
      const int col = (e - r * VPR) * VE;
      float qv[VE], kv[VE], vv[VE];
      if (t0 + r < S) {
        const size_t off = row0 + (size_t)(t0 + r) * H + col;
        load16(q + off, qv);
        load16(k + off, kv);
        load16(v + off, vv);
      } else {
#pragma unroll
        for (int j = 0; j < VE; ++j) qv[j] = kv[j] = vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VE; ++j) {
        sqT[col + j][r] = qv[j] * qk_scale;
        skT[col + j][r] = kv[j];
        sv[r][col + j] = vv[j];
      }
    }

    // gates: one warp, two rows per lane, inclusive scan of logsig(f)
    if (tid < 32) {
      const int r0 = 2 * tid, r1 = r0 + 1;
      float lf0 = 0.f, lf1 = 0.f, li0 = -CUDART_INF_F, li1 = -CUDART_INF_F;
      if (t0 + r0 < S) {
        lf0 = log_sigmoid(fg[gate0 + (size_t)(t0 + r0) * NH]);
        li0 = log_sigmoid(ig[gate0 + (size_t)(t0 + r0) * NH]);
      }
      if (t0 + r1 < S) {
        lf1 = log_sigmoid(fg[gate0 + (size_t)(t0 + r1) * NH]);
        li1 = log_sigmoid(ig[gate0 + (size_t)(t0 + r1) * NH]);
      }
      const float pair = lf0 + lf1;
      float incl = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += y;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      const float b0 = excl + lf0;
      const float b1 = b0 + lf1;
      const float g = __shfl_sync(0xffffffffu, b1, 31);
      sb[r0] = b0;
      sb[r1] = b1;
      seb[r0] = expf(b0);
      seb[r1] = expf(b1);
      sea[r0] = expf((g - b0) + li0);
      sea[r1] = expf((g - b1) + li1);
      sli[r0] = li0;
      sli[r1] = li1;
      if (tid == 0) sg = g;
    }
    __syncthreads();

    // 2. causal q~ k^T * D, one 4x4 tile per thread (upper tiles skipped)
    {
      const int ti = tid / 16, tj = tid % 16;
      if (tj <= ti) {
        float acc[4][4] = {};
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
          const float4 qa = *reinterpret_cast<const float4*>(&sqT[d][ti * 4]);
          const float4 kb = *reinterpret_cast<const float4*>(&skT[d][tj * 4]);
          const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
          const float kr[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(qr[r], kr[s], acc[r][s]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int l = ti * 4 + r;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int j = tj * 4 + s;
            // the exponent is masked before exp: b_l - b_j > 0 above the diagonal
            ssd[l][j] = (j <= l) ? acc[r][s] * expf(sb[l] - sb[j] + sli[j]) : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // 3. h for row l, columns [cc, cc + CPT)
    {
      const int l = tid / 4;
      const int cc = (tid % 4) * CPT;
      float acc[CPT];
#pragma unroll
      for (int x = 0; x < CPT; ++x) acc[x] = 0.f;
      float n_inter = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float qd = sqT[d][l];
        n_inter = fmaf(qd, sn[d], n_inter);
#pragma unroll
        for (int x = 0; x < CPT; x += 4) {
          const float4 cv = *reinterpret_cast<const float4*>(&sc[d][cc + x]);
          acc[x] = fmaf(qd, cv.x, acc[x]);
          acc[x + 1] = fmaf(qd, cv.y, acc[x + 1]);
          acc[x + 2] = fmaf(qd, cv.z, acc[x + 2]);
          acc[x + 3] = fmaf(qd, cv.w, acc[x + 3]);
        }
      }
      const float eb = seb[l];
      n_inter *= eb;
#pragma unroll
      for (int x = 0; x < CPT; ++x) acc[x] *= eb;
      float n_intra = 0.f;
      for (int j = 0; j <= l; ++j) {
        const float s = ssd[l][j];
        n_intra += s;
#pragma unroll
        for (int x = 0; x < CPT; x += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&sv[j][cc + x]);
          acc[x] = fmaf(s, vv.x, acc[x]);
          acc[x + 1] = fmaf(s, vv.y, acc[x + 1]);
          acc[x + 2] = fmaf(s, vv.z, acc[x + 2]);
          acc[x + 3] = fmaf(s, vv.w, acc[x + 3]);
        }
      }
      const float den = fmaxf(fabsf(n_inter + n_intra), 1.f);
      if constexpr (SAVE) {
        if (tid % 4 == 0) den_out[chunk_bh * L + l] = den;
      }
      const float inv = 1.f / (den + eps);
#pragma unroll
      for (int x = 0; x < CPT; ++x) acc[x] *= inv;
      if constexpr (VAR == INFER_LN) {  // per-head LayerNorm of the float32 row
        float s = 0.f;
#pragma unroll
        for (int x = 0; x < CPT; ++x) s += acc[x];
        const float mu = row_sum4(s) / DH;
        float ss = 0.f;
#pragma unroll
        for (int x = 0; x < CPT; ++x) {
          const float d = acc[x] - mu;
          ss = fmaf(d, d, ss);
        }
        const float rstd = rsqrtf(row_sum4(ss) / DH + ln_eps);
        const int col = hd * DH + cc;
#pragma unroll
        for (int x = 0; x < CPT; ++x)
          acc[x] = fmaf((acc[x] - mu) * rstd, lnw[col + x], lnb[col + x]);
      }
      if (t0 + l < S) store_row<T, CPT>(h + row0 + (size_t)(t0 + l) * H + cc, acc);
    }
    __syncthreads();

    // 4. state update: C row dk, columns [dv0, dv0 + VPT)
    {
      const int dk = tid / TPR;
      const int dv0 = (tid % TPR) * VPT;
      const float g = expf(sg);
      float acc[VPT];
#pragma unroll
      for (int x = 0; x < VPT; ++x) acc[x] = 0.f;
      float nacc = 0.f;
#pragma unroll 4
      for (int l = 0; l < L; ++l) {
        const float ka = skT[dk][l] * sea[l];
        nacc += ka;
#pragma unroll
        for (int x = 0; x < VPT; ++x) acc[x] = fmaf(ka, sv[l][dv0 + x], acc[x]);
      }
#pragma unroll
      for (int x = 0; x < VPT; ++x) sc[dk][dv0 + x] = fmaf(g, sc[dk][dv0 + x], acc[x]);
      if (dv0 == 0) sn[dk] = fmaf(g, sn[dk], nacc);
    }
    __syncthreads();
  }

  for (int e = tid; e < DH * DH; e += NT) c_last[cst0 + e] = sc[e / DH][e % DH];
  if (tid < DH) n_last[(size_t)bh * DH + tid] = sn[tid];
}

template <typename T, int DH, int VAR>
int launch(const void* q, const void* k, const void* v, const float* i, const float* f,
           const float* c0, const float* n0, void* h, float* c_last, float* n_last,
           float* c_states, float* n_states, float* den, const float* lnw, const float* lnb,
           int B, int S, int NH, float qk_scale, float eps, float ln_eps, cudaStream_t stream) {
  const size_t smem = sizeof(FwSmem<DH>);
  cudaError_t err = port::allow_smem(chunkwise_fw_kernel<T, DH, VAR>, smem);
  if (err != cudaSuccess) return (int)err;
  chunkwise_fw_kernel<T, DH, VAR><<<B * NH, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), i, f,
      c0, n0, static_cast<T*>(h), c_last, n_last, c_states, n_states, den, lnw, lnb, S, NH,
      qk_scale, eps, ln_eps);
  return (int)cudaGetLastError();
}

template <int VAR>
int dispatch(const void* q, const void* k, const void* v, const float* i, const float* f,
             const float* c0, const float* n0, void* h, float* c_last, float* n_last,
             float* c_states, float* n_states, float* den, const float* lnw, const float* lnb,
             int B, int S, int NH, int DH, int dtype, float qk_scale, float eps, float ln_eps,
             cudaStream_t st) {
  // the compute type is the storage type: every product here is float32
  return port::dispatch(dtype, dtype, DH, [&](auto t, auto, auto dh) -> int {
    using T = decltype(t);
    constexpr int D = decltype(dh)::value;
    return launch<T, D, VAR>(q, k, v, i, f, c0, n0, h, c_last, n_last, c_states, n_states, den,
                             lnw, lnb, B, S, NH, qk_scale, eps, ln_eps, st);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  c0/n0 may be null (zero initial state).
// Returns the CUDA error code of the launch; 1000 for an unsupported dtype
// or head size (the Python wrapper checks both before calling).
extern "C" int chunkwise_fw(const void* q, const void* k, const void* v, const float* i,
                            const float* f, const float* c0, const float* n0, void* h,
                            float* c_last, float* n_last, int B, int S, int NH, int DH,
                            int dtype, float qk_scale, float eps, void* stream) {
  return dispatch<INFER>(q, k, v, i, f, c0, n0, h, c_last, n_last, nullptr, nullptr, nullptr,
                         nullptr, nullptr, B, S, NH, DH, dtype, qk_scale, eps, 0.f,
                         static_cast<cudaStream_t>(stream));
}

// The train variant: also c_states (B, NC, NH, DH, DH), n_states
// (B, NC, NH, DH) and den (B, NC, NH, L), float32, NC = ceil(S / L).
extern "C" int chunkwise_fw_train(const void* q, const void* k, const void* v, const float* i,
                                  const float* f, const float* c0, const float* n0, void* h,
                                  float* c_last, float* n_last, float* c_states,
                                  float* n_states, float* den, int B, int S, int NH, int DH,
                                  int dtype, float qk_scale, float eps, void* stream) {
  return dispatch<TRAIN>(q, k, v, i, f, c0, n0, h, c_last, n_last, c_states, n_states, den,
                         nullptr, nullptr, B, S, NH, DH, dtype, qk_scale, eps, 0.f,
                         static_cast<cudaStream_t>(stream));
}

// The inference variant with the per-head LayerNorm fused in: lnw (the
// caller's 1 + w) and lnb, (NH * DH) float32.
extern "C" int chunkwise_fw_ln(const void* q, const void* k, const void* v, const float* i,
                               const float* f, const float* c0, const float* n0,
                               const float* lnw, const float* lnb, void* h, float* c_last,
                               float* n_last, int B, int S, int NH, int DH, int dtype,
                               float qk_scale, float eps, float ln_eps, void* stream) {
  return dispatch<INFER_LN>(q, k, v, i, f, c0, n0, h, c_last, n_last, nullptr, nullptr,
                            nullptr, lnw, lnb, B, S, NH, DH, dtype, qk_scale, eps, ln_eps,
                            static_cast<cudaStream_t>(stream));
}
