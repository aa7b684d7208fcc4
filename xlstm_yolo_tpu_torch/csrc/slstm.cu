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
// What bounds it.  Bytes: wx (B S 4 D floats) and hs (B S D) once, R and
// the states once; operations: 8 B S D DH flop for the recurrent products.
// Both are far below what one step costs: the scan is serial in S, so its
// time is S times the latency of one step (the products, their reduction,
// the gates and the exchange of h), not either bound.
//
// Design.  A thread-block cluster of K CTAs per (head, group of G batch
// rows) walks the sequence; the Pallas kernel's sequential grid axis
// becomes that loop.  CTA j of the cluster owns U = ceil(DH / K) units e
// for all four gates, so a unit's gate sums, its nonlinearities and its
// (c, n, m) stay in one CTA.  Warp w owns units nu * 8 + w, nu < NU (NU 4
// up to DH 64, else 2), so K is the power of two with K 8 NU >= DH: one CTA
// up to DH 32, 2 up to 64, 8 up to 128, 16 up to 256 (above the portable
// 8, so the non-portable attribute is set once).
//  - R stays on chip for the whole sequence, once per head and group: each
//    lane keeps R[g, head, d, e] of its warp's units and its d = lane + 32
//    kk (kk < ND) in registers, 4 NU ND floats, and uses each for all G
//    rows of the group.
//  - No thread runs a DH-long chain: a lane sums over its ND values of d,
//    for 4 NU G (row, unit, gate) outputs at once; the warp combines the 32
//    lanes' partial sums by a butterfly reduce-scatter (each round keeps
//    half of the values; unrolled at compile time, or the sums leave the
//    registers), and one lane per (row, unit) gathers its four gates by
//    shuffles and updates the state, which it keeps in registers.
//  - h is exchanged through distributed shared memory, double-buffered:
//    that lane sends h' into buffer (t + 1) & 1 of every CTA of the cluster
//    with st.async, which counts its bytes on that CTA's mbarrier of the
//    buffer; a CTA starts step t + 1 when its barrier has all of h(t + 1).
//    No cluster-wide barrier a step (a release / acquire one cost more than
//    the step's own work; PERF.md, PR 15): the writes of step t + 1 cannot
//    overtake the reads of step t, since every CTA's h(t + 1) needs all of
//    h(t), sent after those reads.  A cluster of one CTA stores locally and
//    takes __syncthreads.
//  - x is loaded two steps ahead into registers by the lane that owns its
//    unit; hs is written by that lane, the last state once at the end.
// G is the fewest rows of 1, 2, 4 whose clusters can all be resident at
// once (cudaOccupancyMaxActiveClusters), within the registers.  DH that is
// not a multiple of K and a ragged last group are masked.

#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace port;

namespace {

constexpr int WARPS = NT / 32;
constexpr int MAX_K = 16;  // CTAs a cluster
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of shared address `addr` in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Stores v at shared::cluster address `addr` and counts its 4 bytes on the
// mbarrier at shared::cluster address `bar` of the same CTA.
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// Rounds R.. of the butterfly reduce-scatter of a lane's V partial sums
// over the 32 lanes: round R keeps the lower or upper half by bit 4 - R of
// the lane, so after min(5, log2 V) rounds sum i is complete in the lanes
// (i / VL) << SH (a compile-time recursion: every index is a constant, so
// the sums stay in registers).
template <int V, int R>
__device__ __forceinline__ void reduce_scatter(float (&acc)[V], int lane) {
  if constexpr (R < (ilog2(V) < 5 ? ilog2(V) : 5)) {
    constexpr int s = 16 >> R, half = V >> (R + 1);
    const bool up = lane & s;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? acc[i] : acc[i + half];
      const float keep = up ? acc[i + half] : acc[i];
      acc[i] = keep + __shfl_xor_sync(FULL, send, s);
    }
    reduce_scatter<V, R + 1>(acc, lane);
  }
}

// One cluster per (head, group of G rows): grid (K, NH, ceil(B / G)), the
// cluster (K, 1, 1), so a CTA's rank in it is blockIdx.x.  Warp w owns the
// units u = nu * 8 + w (nu < NU) of its CTA.
template <int ND, int G, int NU>
__global__ void __launch_bounds__(NT, 1) slstm_kernel(
    const float* __restrict__ wx, const float* __restrict__ R, const float* __restrict__ h0,
    const float* __restrict__ c0, const float* __restrict__ n0, const float* __restrict__ m0,
    float* __restrict__ hs, float* __restrict__ h_last, float* __restrict__ c_last,
    float* __restrict__ n_last, float* __restrict__ m_last, int B, int S, int NH, int DH,
    int U) {
  constexpr int DP = 32 * ND;          // h's length in the buffer, DH padded with zeros
  constexpr int V = 4 * NU * G;        // partial sums a lane carries: (row, nu, gate)
  constexpr int RH = ilog2(V) < 5 ? ilog2(V) : 5;  // halving rounds of the reduce-scatter
  constexpr int VL = V >> RH;          // sums a lane holds after them
  constexpr int SH = 5 - RH;           // lanes 2^SH apart then hold the same sums
  __shared__ float hbuf[2][G][DP];     // h(t) of the group's rows in buffer t & 1
  __shared__ __align__(8) unsigned long long mbar[2];  // h(t) of buffer t & 1 has arrived

  cg::cluster_group cluster = cg::this_cluster();
  const int K = gridDim.x, rank = blockIdx.x;
  const int head = blockIdx.y, b0 = blockIdx.z * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = NH * DH;

  // R of this lane: Rr[nu][g][kk] = R[g, head, lane + 32 kk, e(nu)]
  float Rr[NU][4][ND];
#pragma unroll
  for (int nu = 0; nu < NU; ++nu) {
    const int u = nu * WARPS + warp, e = rank * U + u;
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        const int d = lane + 32 * kk;
        Rr[nu][g][kk] = (u < U && e < DH && d < DH)
                            ? R[((size_t)(g * NH + head) * DH + d) * DH + e] : 0.f;
      }
  }
  for (int j = threadIdx.x; j < 2 * G * DP; j += NT) {
    const int buf = j / (G * DP), b = (j / DP) % G, d = j % DP;
    const bool take = buf == 0 && h0 && b0 + b < B && d < DH;
    (&hbuf[0][0][0])[j] = take ? h0[((size_t)(b0 + b) * NH + head) * DH + d] : 0.f;
  }
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&mbar[0])));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&mbar[1])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // bytes of h a step brings every CTA: one float per valid (row, unit)
  const unsigned tx_bytes = 4u * (unsigned)(min(G, B - b0) * DH);

  // The (row, unit) this lane gathers after the reduce-scatter: sums of
  // index (b NU + nu) 4 + g; the lane holding gate 0 updates the unit.
  const int q = ((lane >> SH) * VL) >> 2;
  const int base = ((q * 4) / VL) << SH;
  const bool owner = lane == base;
  const int ob = q / NU, onu = q % NU;
  const int ou = onu * WARPS + warp, oe = rank * U + ou;
  const bool active = owner && ou < U && oe < DH && b0 + ob < B;
  const size_t st = ((size_t)(b0 + ob) * NH + head) * DH + oe;  // (B, NH, DH) states
  float h = 0.f, c = 0.f, n = 0.f, m = 0.f;
  if (active) {
    h = h0 ? h0[st] : 0.f;
    c = c0 ? c0[st] : 0.f;
    n = n0 ? n0[st] : 0.f;
    m = m0 ? m0[st] : 0.f;
  }
  const float* xp = wx + (size_t)(b0 + ob) * S * 4 * D + head * DH + oe;
  float* hp = hs + (size_t)(b0 + ob) * S * D + head * DH + oe;
  auto x_at = [&](int t, int g) {
    return (active && t < S) ? __ldg(xp + ((size_t)t * 4 + g) * D) : 0.f;
  };

  float xa[4], xb[4];  // x of the next two steps
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    xa[g] = x_at(0, g);
    xb[g] = x_at(1, g);
  }
  cluster.sync();  // every CTA has started, holds h0 and its barriers before any remote write

  // Step t reads h(t) from buffer par = t & 1 and sends h(t + 1) to buffer
  // par ^ 1 of every CTA.
  for (int t = 0; t < S; ++t) {
    const int par = t & 1;
    if (K > 1) {
      if (t > 0) mbar_wait(smem_addr(&mbar[par]), ((t - 1) >> 1) & 1);  // h(t) is in
      if (threadIdx.x == 0 && t + 1 < S)  // h(t + 1) will bring tx_bytes
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(smem_addr(&mbar[par ^ 1])), "r"(tx_bytes) : "memory");
    }
    float x[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      x[g] = xa[g];
      xa[g] = xb[g];
      xb[g] = x_at(t + 2, g);
    }
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk)
#pragma unroll
      for (int b = 0; b < G; ++b) {
        const float hv = hbuf[par][b][lane + 32 * kk];
#pragma unroll
        for (int nu = 0; nu < NU; ++nu)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float& a = acc[(b * NU + nu) * 4 + g];
            a = fmaf(hv, Rr[nu][g][kk], a);
          }
      }
    reduce_scatter<V, 0>(acc, lane);
#pragma unroll
    for (int s = 16 >> RH; s > 0; s >>= 1) acc[0] += __shfl_xor_sync(FULL, acc[0], s);
    float pre[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      pre[g] = __shfl_sync(FULL, acc[g % VL], base + ((g / VL) << SH)) + x[g];

    if (active) {
      const float z = tanhf(pre[0]);
      const float it = pre[1], ft = pre[2];
      const float og = 1.f / (1.f + expf(-pre[3]));
      const float m_new = fmaxf(ft + m, it);
      const float ig = expf(it - m_new);
      const float fg = expf(ft + m - m_new);
      c = fg * c + ig * z;
      n = fg * n + ig;
      h = og * c / fmaxf(n, 1e-6f);
      m = m_new;
      float* dst = &hbuf[par ^ 1][ob][oe];
      if (K == 1) {
        *dst = h;
      } else if (t + 1 < S) {
        const unsigned a = smem_addr(dst), bar = smem_addr(&mbar[par ^ 1]);
        for (int r = 0; r < K; ++r) st_async(mapa(a, r), h, mapa(bar, r));
      }
      hp[(size_t)t * D] = h;
    }
    if (K == 1) __syncthreads();  // h(t + 1) in the buffer; this step's reads are done
  }
  if (active) {
    h_last[st] = h;
    c_last[st] = c;
    n_last[st] = n;
    m_last[st] = m;
  }
  cluster.sync();  // no CTA leaves while another may still write to it
}

struct Plan {
  int K, U, ND, G, NU;
};

// The multiprocessors of the current device (read once per device).
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!counts[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

cudaLaunchConfig_t config(const Plan& p, int NH, int B, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.K, (unsigned)NH, (unsigned)((B + p.G - 1) / p.G));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Instance (ND, G, NU) of the kernel, with the cluster-size attribute set
// once (K 16 is above the portable 8); null if that fails.
template <int ND, int G, int NU>
const void* instance(int K) {
  static bool non_portable = false;
  auto kernel = slstm_kernel<ND, G, NU>;
  if (K > 8 && !non_portable) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
        cudaSuccess)
      return nullptr;
    non_portable = true;
  }
  return reinterpret_cast<const void*>(kernel);
}

// The kernel of plan p; null for a plan no instance has.
const void* kernel_for(const Plan& p) {
#define SLSTM_INSTANCE(ND_, G_, NU_) \
  if (p.ND == ND_ && p.G == G_ && p.NU == NU_) return instance<ND_, G_, NU_>(p.K);
  SLSTM_INSTANCE(1, 1, 4) SLSTM_INSTANCE(1, 2, 4) SLSTM_INSTANCE(1, 4, 4)
  SLSTM_INSTANCE(2, 1, 4) SLSTM_INSTANCE(2, 2, 4)
  SLSTM_INSTANCE(4, 1, 2) SLSTM_INSTANCE(4, 2, 2) SLSTM_INSTANCE(4, 4, 2)
  SLSTM_INSTANCE(8, 1, 2) SLSTM_INSTANCE(8, 2, 2)
#undef SLSTM_INSTANCE
  return nullptr;
}

// K, U, NU and ND follow from DH: a warp owns NU = 4 units up to DH 64 (one
// CTA up to DH 32), else 2, so a CTA owns 8 NU; ND = ceil(DH / 32) rounded
// to a power of two.  G is the fewest rows (so the least work a step) whose
// clusters can all be resident at once (cudaOccupancyMaxActiveClusters, read
// once per instance and K), within what the registers take: the lane's R (4
// NU ND floats) and sums (4 NU G) at most 80.
Plan plan_for(int B, int NH, int DH) {
  Plan p;
  p.NU = DH <= 64 ? 4 : 2;
  p.K = 1;
  while (p.K * p.NU * WARPS < DH) p.K *= 2;
  p.U = (DH + p.K - 1) / p.K;
  p.ND = 1;
  while (32 * p.ND < DH) p.ND *= 2;
  const int g_cap = (80 / (4 * p.NU)) - p.ND;
  int g_max = 1;
  while (g_max * 2 <= g_cap && g_max < 8) g_max *= 2;
  static int resident[64][5][4][4][2] = {};  // device, K, ND, G, NU: clusters + 1
  int dev = 0;
  cudaGetDevice(&dev);
  for (p.G = 1;; p.G *= 2) {
    const long long clusters = (long long)NH * ((B + p.G - 1) / p.G);
    if (p.G >= g_max) break;
    int& fit = resident[dev & 63][ilog2(p.K)][ilog2(p.ND)][ilog2(p.G)][p.NU == 4];
    if (!fit) {
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg = config(p, NH, B, nullptr, attr);
      const void* kernel = kernel_for(p);
      int n = 0;
      if (!kernel || cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
        cudaGetLastError();
        n = sm_count() / (2 * p.K);
      }
      fit = n + 1;
    }
    if (clusters <= fit - 1) break;
  }
  return p;
}

}  // namespace

// The launch plan for (B, NH, DH) on the current device: out[0..4] = K
// (CTAs a cluster), U (units a CTA), ND (d a lane, per 32), G (batch rows a
// cluster), NU (units a warp).  1000 for shapes the kernel does not take.
extern "C" int slstm_plan(int B, int NH, int DH, int* out) {
  if (B <= 0 || NH <= 0 || DH <= 0 || DH > MAX_K * 16) return 1000;
  const Plan p = plan_for(B, NH, DH);
  out[0] = p.K;
  out[1] = p.U;
  out[2] = p.ND;
  out[3] = p.G;
  out[4] = p.NU;
  return 0;
}

// wx (B, S, 4, NH, DH), R (4, NH, DH, DH), the initial h, c, n, m (B, NH,
// DH) or null for zeros; hs (B, S, NH DH) and the last h, c, n, m out; all
// float32.  Returns a CUDA error code (also where the cluster cannot be
// launched); 1000 for shapes the kernel does not take (DH outside 1..256).
extern "C" int slstm_forward(const float* wx, const float* R, const float* h0, const float* c0,
                             const float* n0, const float* m0, float* hs, float* h_last,
                             float* c_last, float* n_last, float* m_last, int B, int S, int NH,
                             int DH, void* stream) {
  if (B <= 0 || S < 0 || NH <= 0 || DH <= 0 || DH > MAX_K * 16 || NH > 65535) return 1000;
  const Plan p = plan_for(B, NH, DH);
  if ((B + p.G - 1) / p.G > 65535) return 1000;
  const void* kernel = kernel_for(p);
  if (!kernel) return 1000;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(p, NH, B, static_cast<cudaStream_t>(stream), attr);
  void* args[] = {&wx, &R, &h0, &c0, &n0, &m0, &hs, &h_last, &c_last, &n_last, &m_last,
                  &B, &S, &NH, &DH, const_cast<int*>(&p.U)};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
