// Chunkwise sigmoid-input-gate mLSTM forward for Hopper, sm_90a: inference and
// train variants.
//
// Replaces the TPU kernels `_fw_kernel_infer` (xlstm_yolo_tpu/ops/pallas/
// chunkwise_v2.py:245) and `_fw_kernel_train` (:238), body `_fw_body` :130,
// and the host-side gate packing `_pack_gates` (:259).  The train variant
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
// load, h is rounded once on store.
//
// What bounds it.  The function is memory-bound by a wide margin (about 46
// FLOP per byte moved at DH = 32, L = 64 in bf16, against the card's ~295
// for bf16 tensor-core work).  This first version does not reach that
// bound.  Occupancy: the grid has only B*NH blocks, 96 at batch 8 on 132
// SMs, one block of 8 warps per SM (47.5 KB of static shared memory at
// DH = 32), so 36 SMs idle and each busy SM runs 8 of its 64 warp slots.
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

namespace {

constexpr int L = 64;     // chunk rows
constexpr int NT = 256;   // threads per block
constexpr int LP = L + 4; // padded row length of the transposed q/k tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* y) { *y = __float2bfloat16(x); }

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

template <typename T, int DH, bool SAVE>
__global__ void __launch_bounds__(NT) chunkwise_fw_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg,
    const float* __restrict__ c0, const float* __restrict__ n0,
    T* __restrict__ h, float* __restrict__ c_last, float* __restrict__ n_last,
    float* __restrict__ c_states, float* __restrict__ n_states, float* __restrict__ den_out,
    int S, int NH, float qk_scale, float eps) {
  static_assert(DH == 16 || DH == 32, "head dim 16 or 32");
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = DH / VE;        // 16-byte loads per head row
  constexpr int CPT = DH / 4;         // h columns per thread (4 threads per row)
  constexpr int TPR = NT / DH;        // threads per C row in the state update
  constexpr int VPT = DH / TPR;       // C columns per thread

  __shared__ __align__(16) float sqT[DH][LP];  // q~ transposed
  __shared__ __align__(16) float skT[DH][LP];  // k transposed
  __shared__ __align__(16) float sv[L][DH];
  __shared__ float ssd[L][L + 1];              // causal q~ k^T * D
  __shared__ __align__(16) float sc[DH][DH];   // C state
  __shared__ float sn[DH];                     // n state
  __shared__ float sb[L], seb[L], sea[L], sli[L];
  __shared__ float sg;

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

template <typename T, int DH, bool SAVE>
void launch(const void* q, const void* k, const void* v, const float* i, const float* f,
            const float* c0, const float* n0, void* h, float* c_last, float* n_last,
            float* c_states, float* n_states, float* den, int B, int S, int NH, float qk_scale,
            float eps, cudaStream_t stream) {
  chunkwise_fw_kernel<T, DH, SAVE><<<B * NH, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), i, f,
      c0, n0, static_cast<T*>(h), c_last, n_last, c_states, n_states, den, S, NH, qk_scale, eps);
}

template <bool SAVE>
int dispatch(const void* q, const void* k, const void* v, const float* i, const float* f,
             const float* c0, const float* n0, void* h, float* c_last, float* n_last,
             float* c_states, float* n_states, float* den, int B, int S, int NH, int DH,
             int dtype, float qk_scale, float eps, cudaStream_t st) {
  if (dtype == 0 && DH == 32)
    launch<float, 32, SAVE>(q, k, v, i, f, c0, n0, h, c_last, n_last, c_states, n_states, den,
                            B, S, NH, qk_scale, eps, st);
  else if (dtype == 0 && DH == 16)
    launch<float, 16, SAVE>(q, k, v, i, f, c0, n0, h, c_last, n_last, c_states, n_states, den,
                            B, S, NH, qk_scale, eps, st);
  else if (dtype == 1 && DH == 32)
    launch<__nv_bfloat16, 32, SAVE>(q, k, v, i, f, c0, n0, h, c_last, n_last, c_states,
                                    n_states, den, B, S, NH, qk_scale, eps, st);
  else if (dtype == 1 && DH == 16)
    launch<__nv_bfloat16, 16, SAVE>(q, k, v, i, f, c0, n0, h, c_last, n_last, c_states,
                                    n_states, den, B, S, NH, qk_scale, eps, st);
  else
    return 1000;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  c0/n0 may be null (zero initial state).
// Returns cudaGetLastError() after the launch; 1000 for an unsupported
// dtype or head size (the Python wrapper checks both before calling).
extern "C" int chunkwise_fw(const void* q, const void* k, const void* v, const float* i,
                            const float* f, const float* c0, const float* n0, void* h,
                            float* c_last, float* n_last, int B, int S, int NH, int DH,
                            int dtype, float qk_scale, float eps, void* stream) {
  return dispatch<false>(q, k, v, i, f, c0, n0, h, c_last, n_last, nullptr, nullptr, nullptr,
                         B, S, NH, DH, dtype, qk_scale, eps, static_cast<cudaStream_t>(stream));
}

// The train variant: also c_states (B, NC, NH, DH, DH), n_states
// (B, NC, NH, DH) and den (B, NC, NH, L), float32, NC = ceil(S / L).
extern "C" int chunkwise_fw_train(const void* q, const void* k, const void* v, const float* i,
                                  const float* f, const float* c0, const float* n0, void* h,
                                  float* c_last, float* n_last, float* c_states,
                                  float* n_states, float* den, int B, int S, int NH, int DH,
                                  int dtype, float qk_scale, float eps, void* stream) {
  return dispatch<true>(q, k, v, i, f, c0, n0, h, c_last, n_last, c_states, n_states, den, B,
                        S, NH, DH, dtype, qk_scale, eps, static_cast<cudaStream_t>(stream));
}
