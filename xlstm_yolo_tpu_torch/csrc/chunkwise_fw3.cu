// Sub-chunked chunkwise sigmoid-input-gate mLSTM forward for Hopper, sm_90a:
// the gate rows, a state pass and an output pass, the last two on the
// tensor cores in bf16.
//
// Replaces the TPU kernel `fw3` (xlstm_yolo_tpu/ops/pallas/chunkwise_fw3.py
// :210; pallas_calls :279 train and :305 inference, body `_fw3_body` :90)
// and its host-side gate packing `_pack_gates_sub` (:58).  It computes the
// v2 forward's function with each chunk of L rows walked as sub-chunks of
// Lb rows (Lb = L where Lb does not divide L), over the sequence padded to
// NC = ceil(S / L) chunks, NS = NC L / Lb sub-chunks.  Per sub-chunk s,
// with b the within-sub-chunk cumsum of logsig(f), a = (b_last - b) +
// logsig(i), g = b_last:
//
//   C_{s+1} = e^g C_s + R(k e^a)^T R(v),   n_{s+1} = e^g n_s + sum_l k_l e^{a_l},
//   sd      = tril((R(q) R(k)^T) qk_scale * e^{b_l - b_j + logsig(i_j)}),
//   h       = (R(q e^b qk_scale) R(C_s) + R(sd) R(v)) / (den + eps),
//   den     = max(|(q e^b qk_scale) . n_s + rowsum sd|, 1),
//
// R() rounding a product's operand to the compute type CT where the JAX
// kernel casts it (CT is the caller's, independent of q's type), every sum
// in float32.
//
// Layout.  q, k, v and h are (B, S, NH*DH), a head a DH-wide column slice of
// each row (no copy or transpose is made); i and f (B, S, NH) float32; the
// states float32: c0, c_last (B, NH, DH, DH), n0, n_last (B, NH, DH).  Rows
// past S load as zero and their gates are inert; h is stored for rows < S,
// the train variant's den n_out (B, NC, NH, L) for every row (1 past S) and
// its cstates (B, NC, NH, DH, DH), the float32 state before each chunk, so
// that the v2 backward takes them.
//
// What bounds it.  The function reads q, k, v and the gates once and writes
// h once (the train variant also cstates and n_out): 315 MB at B 8, S 6400,
// NH 6, DH 128 in bf16, 94 us at 3.35 TB/s, against 4 B NH S DH (Lb + DH)
// flop (40 us at 989 TFLOP/s for Lb 128): bound by bytes.  The sub-chunked
// recurrence adds the state before each sub-chunk, written by the state
// pass and read by the output pass: (B, NS, NH, DH, DH) in CT, 79 MB at DH
// 128 in bf16 (half the float32 scratch of the first design).
//
// Design.  fw3's sub-chunks are the v1 route's chunks in another layout:
// the same recurrence, the same rounding points, a state before each.  So
// the two passes are the v1 forward's kernels of chunkwise_v1.cuh,
// fw_scan_kernel and fw_h_kernel, run with F3 set (Sub): a block of 4 warps
// per (batch * head, 16 rows of C) walks the sub-chunks in 64-row tiles on
// mma.sync, C in float32 registers, k, v and the next tile's row factors
// loading by cp.async while the current tile is multiplied; then a block of
// 4 warps per (batch * head, sub-chunk, 64-row sub-tile) makes R(qbar)
// R(C_s) and walks the sub-chunk's key tiles up to its own, two deep, the
// score fragment scaled by D in registers and fed to the product with R(v).
// A sub-chunk of Lb rows is walked as L = Lb rounded up to whole tiles (16
// rows below 64, else 64), its padding rows zero with inert gates, so every
// Lb runs: 8, 100, 400, 640.  Neither pass holds a sub-chunk's gates, which
// have no bound on their length: fw3_gates_kernel, one warp per (batch *
// head, sub-chunk), makes b, logsig(i) and e^a for every row and e^g for
// every sub-chunk first, folding the cumsum over 64-row tiles with a carry
// (the carry out of a tile is b of its last valid row, to the bit, so a =
// logsig(i) exactly there, as in the JAX packing); the passes load a tile's
// rows with the tile, and both read one b.  Three launches a call.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "chunkwise_v1.cuh"

namespace {

using v1::Sub;

constexpr int GW = 4;  // warps of a gate-row block, one (batch * head, sub-chunk) each

// The gate rows of each (batch * head bh, sub-chunk c), warp w = bh NS + c:
// rows r < L of b (from the sub-chunk's start), logsig(i) and e^a into gb,
// gli, gfac (BNH, NS, L), e^g into geg (BNH, NS).  Rows past Lb or S are
// inert: logsig(f) 0, logsig(i) -inf, e^a 0.  Two rows a lane a 64-row tile,
// a shuffle scan, the carry b of the tile's last valid row.
__global__ void __launch_bounds__(32 * GW) fw3_gates_kernel(
    const float* __restrict__ ig, const float* __restrict__ fg, float* __restrict__ gb,
    float* __restrict__ gli, float* __restrict__ gfac, float* __restrict__ geg, int BNH, int S,
    int NH, int Lb, int L, int NS) {
  const int w = blockIdx.x * GW + (threadIdx.x >> 5);
  if (w >= BNH * NS) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int bh = w / NS, c = w - bh * NS;
  const int hb = bh / NH, hd = bh - hb * NH;
  const int nv = max(0, min(Lb, S - c * Lb));  // rows of the sub-chunk before S
  const size_t gate0 = ((size_t)hb * S + (size_t)c * Lb) * NH + hd;
  const size_t row0 = (size_t)w * L;
  float carry = 0.f;
  for (int r0 = 0; r0 < L; r0 += 64) {
    const int ra = r0 + 2 * lane, rb = ra + 1;
    float fa = 0.f, fb = 0.f, la = -CUDART_INF_F, lb = -CUDART_INF_F;
    if (ra < nv) {
      fa = v1::log_sigmoid(fg[gate0 + (size_t)ra * NH]);
      la = v1::log_sigmoid(ig[gate0 + (size_t)ra * NH]);
    }
    if (rb < nv) {
      fb = v1::log_sigmoid(fg[gate0 + (size_t)rb * NH]);
      lb = v1::log_sigmoid(ig[gate0 + (size_t)rb * NH]);
    }
    float incl = fa + fb;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float b0 = excl + fa, b1 = b0 + fb;
    if (ra < L) {
      gb[row0 + ra] = carry + b0;
      gli[row0 + ra] = la;
    }
    if (rb < L) {
      gb[row0 + rb] = carry + b1;
      gli[row0 + rb] = lb;
    }
    const int last = min(nv - r0, 64) - 1;  // the tile's last valid row
    if (last >= 0) carry = carry + __shfl_sync(0xffffffffu, (last & 1) ? b1 : b0, last >> 1);
  }
  const float gl = carry;  // b of the sub-chunk's last valid row (0 with none)
  for (int r0 = 0; r0 < L; r0 += 64)  // each lane reads back its own rows
    for (int r = r0 + 2 * lane; r < min(r0 + 2 * lane + 2, L); ++r)
      gfac[row0 + r] = expf((gl - gb[row0 + r]) + gli[row0 + r]);
  if (lane == 0) geg[w] = expf(gl);
}

// The walked length of a sub-chunk of Lb rows: whole 64-row tiles, or Lb
// rounded up to 16 below 64 (the mma's depth).
inline int padded(int Lb) {
  const int t = Lb >= v1::TR ? v1::TR : (Lb + 15) / 16 * 16;
  return (Lb + t - 1) / t * t;
}

// The Sub of a call; gates is the gate-row scratch, (3 L + 1) BNH NS floats.
inline Sub sub_of(const float* gates, float* cstates, float* n_out, int B, int S, int NH, int L3,
                  int Lb) {
  Sub sub;
  const int L = padded(Lb);
  sub.NH = NH;
  sub.Lb = Lb;
  sub.NB = L3 / Lb;
  sub.NS = (S + L3 - 1) / L3 * sub.NB;
  const size_t n = (size_t)B * NH * sub.NS * L;
  sub.b = gates;
  sub.li = gates + n;
  sub.fac = gates + 2 * n;
  sub.eg = gates + 3 * n;
  sub.cstates = cstates;
  sub.n_out = n_out;
  return sub;
}

}  // namespace

// Arguments shared by the three passes: B, S, NH, DH; L3 the chunk and Lb
// the sub-chunk (Lb divides L3); dtype and cdtype the storage and compute
// types (0 float32, 1 bfloat16).  gates: the gate-row scratch, float32, (3 P
// + 1) B NH NS floats, P = Lb rounded up to whole tiles (16 rows below 64,
// else 64), NS = ceil(S / L3) L3 / Lb.  Each returns the CUDA error code of
// its launch; 1000 for a dtype or head size the kernels do not take (the
// Python wrapper checks both before calling).

// The gate rows, from i and f (B, S, NH) float32.
extern "C" int fw3_gates(const float* i, const float* f, float* gates, int B, int S, int NH,
                         int L3, int Lb, void* stream) {
  const Sub sub = sub_of(gates, nullptr, nullptr, B, S, NH, L3, Lb);
  const int L = padded(Lb), warps = B * NH * sub.NS;
  fw3_gates_kernel<<<(warps + GW - 1) / GW, 32 * GW, 0, static_cast<cudaStream_t>(stream)>>>(
      i, f, const_cast<float*>(sub.b), const_cast<float*>(sub.li), const_cast<float*>(sub.fac),
      const_cast<float*>(sub.eg), B * NH, S, NH, Lb, L, sub.NS);
  return (int)cudaGetLastError();
}

// The state pass, after fw3_gates: c_scr (B, NS, NH, DH, DH) in the compute
// type and n_scr (B, NS, NH, DH) float32, the state before each sub-chunk;
// cstates (B, NC, NH, DH, DH) float32 or null (inference, or c_scr is it);
// c_last, n_last; c0, n0 null for a zero initial state.
extern "C" int fw3_states(const void* k, const void* v, const float* c0, const float* n0,
                          const float* gates, void* c_scr, float* n_scr, float* cstates,
                          float* c_last, float* n_last, int B, int S, int NH, int DH, int L3,
                          int Lb, int dtype, int cdtype, void* stream) {
  const Sub sub = sub_of(gates, cstates, nullptr, B, S, NH, L3, Lb);
  return port::dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dh) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dh)::value;
    using Scan = v1::ScanTile<T, CT, D, true>;
    cudaError_t err = port::allow_smem(v1::fw_scan_kernel<T, CT, D, false, true>, Scan::bytes);
    if (err != cudaSuccess) return (int)err;
    v1::fw_scan_kernel<T, CT, D, false, true><<<dim3(B * NH, D / Scan::TRW), par::NTC, Scan::bytes,
                                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(k), static_cast<const T*>(v), nullptr, nullptr, c0, n0,
        static_cast<CT*>(c_scr), n_scr, c_last, n_last, S, padded(Lb), v1::MState{}, sub);
    return (int)cudaGetLastError();
  });
}

// The output pass, after fw3_states on the same stream: h (B, S, NH*DH) in
// the storage type; n_out (B, NC, NH, L3) float32 or null (inference).
extern "C" int fw3_out(const void* q, const void* k, const void* v, const float* gates,
                       const void* c_scr, const float* n_scr, void* h, float* n_out, int B,
                       int S, int NH, int DH, int L3, int Lb, int dtype, int cdtype,
                       float qk_scale, float eps, void* stream) {
  const Sub sub = sub_of(gates, nullptr, n_out, B, S, NH, L3, Lb);
  const int L = padded(Lb);
  const long long blocks = (long long)sub.NS * (L / v1::tile_rows(L));  // a column of the grid
  const dim3 grid(B * NH, (unsigned)(blocks < 65535 ? blocks : 65535),
                  (unsigned)((blocks + 65534) / 65535));
  return port::dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dh) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dh)::value;
    const size_t smem = v1::OutTile<CT, D, true>::bytes;
    cudaError_t err = port::allow_smem(v1::fw_h_kernel<T, CT, D, false, true>, smem);
    if (err != cudaSuccess) return (int)err;
    v1::fw_h_kernel<T, CT, D, false, true><<<grid, par::NTC, smem,
                                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), nullptr,
        nullptr, static_cast<const CT*>(c_scr), n_scr, static_cast<T*>(h), nullptr, S, L,
        qk_scale, eps, v1::MState{}, sub);
    return (int)cudaGetLastError();
  });
}
