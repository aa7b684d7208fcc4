// sLSTM sequence scan for Hopper, sm_90a.
//
// Replaces the TPU kernel `_kernel` (xlstm_yolo_tpu/ops/pallas/slstm.py:42,
// launched by `slstm_sequence_pallas` :92, call :117).  For each (batch,
// head), over the S steps, with gates g = z, i, f, o:
//
//   rh_g[e] = sum_d h[d] R[g, head, d, e]
//   z = tanh(x_z + rh_z),  i~ = x_i + rh_i,  f~ = x_f + rh_f,  o = sigmoid(x_o + rh_o)
//   m' = max(f~ + m, i~),  ig = e^{i~ - m'},  fg = e^{f~ + m - m'}
//   c' = fg c + ig z,  n' = fg n + ig,  h' = o c' / max(n', 1e-6)
//
// All float32, as in JAX (R is kept in float32 there too).
//
// Design.  One block of 256 threads per (batch, head) walks the sequence;
// the Pallas kernel's sequential grid axis becomes that loop.  The state
// (h, c, n, m) stays in shared memory for the whole sequence.  Each step,
// thread t computes the recurrent sums of outputs o = t, t + 256, ... of
// the 4 DH (gate, unit) pairs, reading h from shared memory and R's column,
// and adds the input x; after a barrier the first DH threads update the
// state and write h.  R of one head is 4 DH^2 floats, 256 KB at DH = 128:
// more than a block's 227 KB of shared memory.  So as many gates as fit are
// staged in shared memory once (all four up to DH = 64, three at DH = 128),
// and the rest is read from device memory on every step, where it stays in
// L1/L2 (R of all heads is 1 MB at the language model's 4 heads of 128).
// The next step's x is loaded before the current step's sums, so its
// latency overlaps them.  The head dim is a runtime value (1 to 256).
//
// What bounds it.  Bytes: wx (B S 4 D floats) and hs (B S D) once, R and
// the states once; operations: 8 B S D DH flop for the recurrent products,
// far below the card's rate.  At B 8, S 2048, D 512 that is 168 MB, 50 us.
// The scan is serial in S: each step costs a few barriers and a DH-long
// dependent sum, which sets the kernel's time (PERF.md), not the bound.

#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

using namespace port;

namespace {

// Outputs (gate, unit) per thread: MAXO = ceil(4 DH / NT).
template <int MAXO>
__global__ void __launch_bounds__(NT) slstm_kernel(
    const float* __restrict__ wx, const float* __restrict__ R, const float* __restrict__ h0,
    const float* __restrict__ c0, const float* __restrict__ n0, const float* __restrict__ m0,
    float* __restrict__ hs, float* __restrict__ h_last, float* __restrict__ c_last,
    float* __restrict__ n_last, float* __restrict__ m_last, int S, int NH, int DH, int staged) {
  extern __shared__ float smem[];
  float* sh = smem;         // (DH) h
  float* sc = sh + DH;      // (DH) c
  float* sn = sc + DH;      // (DH) n
  float* sm = sn + DH;      // (DH) m
  float* pre = sm + DH;     // (4, DH) gate pre-activations of this step
  float* sR = pre + 4 * DH; // (staged, DH, DH) the first `staged` gates of R

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / NH, head = bh - b * NH;
  const int D = NH * DH;
  const int DD = DH * DH;
  const int nout = 4 * DH;
  const size_t state0 = (size_t)bh * DH;  // (B, NH, DH) states

  for (int j = tid; j < staged * DD; j += NT) {
    const int g = j / DD;
    sR[j] = R[(size_t)(g * NH + head) * DD + (j - g * DD)];
  }
  for (int e = tid; e < DH; e += NT) {
    sh[e] = h0 ? h0[state0 + e] : 0.f;
    sc[e] = c0 ? c0[state0 + e] : 0.f;
    sn[e] = n0 ? n0[state0 + e] : 0.f;
    sm[e] = m0 ? m0[state0 + e] : 0.f;
  }

  // x of output o at step t: wx[b, t, g, head, e], o = g DH + e
  auto x_at = [&](int t, int o) {
    const int g = o / DH;
    return wx[(((size_t)b * S + t) * 4 + g) * D + head * DH + (o - g * DH)];
  };
  float xn[MAXO];
#pragma unroll
  for (int j = 0; j < MAXO; ++j) {
    const int o = tid + j * NT;
    xn[j] = (S > 0 && o < nout) ? x_at(0, o) : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    float xc[MAXO];
#pragma unroll
    for (int j = 0; j < MAXO; ++j) {
      const int o = tid + j * NT;
      xc[j] = xn[j];
      if (t + 1 < S && o < nout) xn[j] = x_at(t + 1, o);
    }
#pragma unroll
    for (int j = 0; j < MAXO; ++j) {
      const int o = tid + j * NT;
      if (o >= nout) break;
      const int g = o / DH, e = o - g * DH;
      float acc = 0.f;
      if (g < staged) {
        const float* Rg = sR + g * DD + e;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) acc = fmaf(sh[d], Rg[d * DH], acc);
      } else {
        const float* Rg = R + (size_t)(g * NH + head) * DD + e;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) acc = fmaf(sh[d], __ldg(Rg + (size_t)d * DH), acc);
      }
      pre[o] = xc[j] + acc;
    }
    __syncthreads();
    for (int e = tid; e < DH; e += NT) {
      const float z = tanhf(pre[e]);
      const float it = pre[DH + e];
      const float ft = pre[2 * DH + e];
      const float og = 1.f / (1.f + expf(-pre[3 * DH + e]));
      const float m = sm[e];
      const float m_new = fmaxf(ft + m, it);
      const float ig = expf(it - m_new);
      const float fg = expf(ft + m - m_new);
      const float c = fg * sc[e] + ig * z;
      const float n = fg * sn[e] + ig;
      const float h = og * c / fmaxf(n, 1e-6f);
      sh[e] = h;
      sc[e] = c;
      sn[e] = n;
      sm[e] = m_new;
      hs[((size_t)b * S + t) * D + head * DH + e] = h;
    }
    __syncthreads();
  }
  for (int e = tid; e < DH; e += NT) {
    h_last[state0 + e] = sh[e];
    c_last[state0 + e] = sc[e];
    n_last[state0 + e] = sn[e];
    m_last[state0 + e] = sm[e];
  }
}

}  // namespace

// wx (B, S, 4, NH, DH), R (4, NH, DH, DH), the initial h, c, n, m (B, NH,
// DH) or null for zeros; hs (B, S, NH DH) and the last h, c, n, m out; all
// float32.  Returns a CUDA error code; 1000 for shapes the kernel does not
// take (DH outside 1..256).
extern "C" int slstm_forward(const float* wx, const float* R, const float* h0, const float* c0,
                             const float* n0, const float* m0, float* hs, float* h_last,
                             float* c_last, float* n_last, float* m_last, int B, int S, int NH,
                             int DH, void* stream) {
  if (B <= 0 || S < 0 || NH <= 0 || DH <= 0 || DH > 256) return 1000;
  constexpr size_t kSmemMax = 232448;  // bytes a block can use on sm_90
  const size_t state_bytes = sizeof(float) * 8 * (size_t)DH;
  const size_t gate_bytes = sizeof(float) * (size_t)DH * DH;
  const int staged = (int)std::min<size_t>(4, (kSmemMax - state_bytes) / gate_bytes);
  const size_t smem = state_bytes + staged * gate_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(B * NH));
  const int maxo = (4 * DH + NT - 1) / NT;
  if (maxo <= 1)
    return launch_with_smem(slstm_kernel<1>, grid, smem, st, wx, R, h0, c0, n0, m0, hs, h_last,
                            c_last, n_last, m_last, S, NH, DH, staged);
  if (maxo <= 2)
    return launch_with_smem(slstm_kernel<2>, grid, smem, st, wx, R, h0, c0, n0, m0, hs, h_last,
                            c_last, n_last, m_last, S, NH, DH, staged);
  return launch_with_smem(slstm_kernel<4>, grid, smem, st, wx, R, h0, c0, n0, m0, hs, h_last,
                          c_last, n_last, m_last, S, NH, DH, staged);
}
