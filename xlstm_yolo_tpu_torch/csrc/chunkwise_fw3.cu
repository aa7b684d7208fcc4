// Sub-chunked chunkwise sigmoid-input-gate mLSTM forward for Hopper, sm_90a:
// a state pass, then an output pass that is parallel over sub-chunks.
//
// Replaces the TPU kernel `fw3` (xlstm_yolo_tpu/ops/pallas/chunkwise_fw3.py
// :210; pallas_calls :279 train and :305 inference, body `_fw3_body` :90)
// and its host-side gate packing `_pack_gates_sub` (:58).  It computes the
// v2 forward's function with each chunk of L rows walked as sub-chunks of
// Lb rows (Lb = L where Lb does not divide L), over the sequence padded to
// NC = ceil(S / L) chunks, NS = NC * L / Lb sub-chunks.  Per sub-chunk s,
// with b the within-sub-chunk cumsum of logsig(f), a = (b_last - b) +
// logsig(i), g = b_last:
//
//   C_{s+1} = e^g C_s + (k e^a)^T v,     n_{s+1} = e^g n_s + sum_l k_l e^{a_l},
//   sd      = tril((q k^T) qk_scale * e^{b_l - b_j + logsig(i_j)}),
//   h       = ((q e^b qk_scale) C_s + sd v) / (max(|(q e^b qk_scale) n_s + rowsum sd|, 1) + eps).
//
// The operands of the four products (q k^T, sd v, (q e^b qk_scale) C_s,
// (k e^a)^T v) are rounded to the compute type CT where the JAX kernel
// rounds them, and every sum runs in float32 FMA: with CT = bfloat16 that is
// what the tensor cores' bf16 products with float32 sums would give, with
// CT = float32 plain float32 (no TF32).  The gate prep (logsig, cumsum),
// left to XLA on the TPU, is done here by one warp per 64-row tile.
//
// Layout.  q, k, v and h are (B, S, NH*DH), i and f (B, S, NH) float32, the
// states float32: c0, c_last (B, NH, DH, DH), n0, n_last (B, NH, DH).  Rows
// past S (and past a sub-chunk that is not a whole number of 64-row tiles)
// are zero-loaded and their gates made inert (logsig f = 0, logsig i =
// -inf); h is stored for rows < S only, the denominator for every row of a
// chunk (1 past S).  The train variant also writes n_out (B, NC, NH, L) and
// cstates (B, NC, NH, DH, DH), the state before each chunk: the v2 train
// forward's den and c_states, so its backward takes them.
//
// Design.  The TPU kernel walks the sub-chunks of each (batch, head) in
// order in one grid step.  Here the walk is split in two launches:
//
// - fw3_states: one block of 256 threads per (batch, head, 32x32 tile of C)
//   (the whole 16x16 C at DH 16) walks the sub-chunks in order, its tile of
//   C (4 entries a thread, 1 at DH 16) and n in registers.  Per sub-chunk it
//   stores the state before it into the scratch buffer c_scr (B, NS, NH, DH,
//   DH) and n_scr (B, NS, NH, DH), float32, then adds (k e^a)^T v over the
//   sub-chunk's 64-row tiles.  Grid B*NH*(DH/32)^2: 96 blocks at vil-det-192
//   (B 8, NH 12, DH 32), 768 at vil-det-384 (NH 6, DH 128).  Shared memory
//   (static) 16.9 KB (8.7 KB at DH 16).
// - fw3_out: one block of 256 threads per (batch, head, sub-chunk, tile of
//   64 rows), all independent.  It loads its q tile, then for each 64-column
//   tile up to the diagonal the k and v tiles, forms the causal s * D tile
//   (a 4x4 register tile a thread) and adds sd v and rowsum sd; last the
//   inter part (q e^b qk_scale) C_s with C_s read from c_scr through L1/L2.
//   Each row's h (DH/4 columns a thread, 4 threads a row) is stored once.
//   Grid B*NH x NS x ceil(Lb/64): at S = 6400, Lb = 128, 9,600 blocks at
//   vil-det-192 and 4,800 at vil-det-384 (the v2 forward has 96 and 48).
//   Shared memory (dynamic, OutSmem) 4 (2 DH 68 + 64 DH + 64 65 + 3 64)
//   bytes: 30.2 KB at DH 16, 43.0 KB at 32, 68.6 KB at 64 and 119.8 KB at
//   128 (one block an SM there, up to five at DH 32).
//
// The scratch buffer is NS * B * NH * DH^2 * 4 bytes: 157 MB at vil-det-384
// and 20 MB at vil-det-192 for S = 6400, Lb = 128.
//
// What bounds it.  The function moves q, k, v, h and the gates once and
// does 4 B NH S DH (Lb + DH) FLOP: memory-bound (at S = 6400, Lb = 128 in
// bf16: 94 us for the bytes against 40 us for the work at DH 128).  This
// first version runs on the CUDA cores in float32 FMA, reads each k and v
// tile once per C tile (state pass) and once per row tile at or below it
// (output pass), and writes and reads the scratch buffer; no tensor cores,
// no copy overlapped with compute.  Its measured times, beside the v2
// forward's on the same inputs, are in PERF.md (chip_smoke.py, fw3_times).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using port::rt;
using port::to_f32;

constexpr int R = 64;      // rows of a tile
constexpr int NT = 256;    // threads per block
constexpr int RP = R + 4;  // padded row length of the transposed q/k tiles

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

// Store 4 consecutive values as T (16 bytes for float32, 8 for bfloat16).
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  uint2 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = __float2bfloat16(x[j]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The gates of the 64 rows [r0, r0 + 64) of a sub-chunk of lb rows that
// starts at sequence row seq0, for the lanes of one warp (rows r0 + 2 lane
// and r0 + 2 lane + 1).  b (through ba, bb) is carry plus the inclusive
// scan of logsig(f) over the tile; logsig(i) through la, lb_.  Rows past
// the sub-chunk or past S are inert.  Returns carry plus the tile's sum, as
// b of its last valid row (carry where it has none).
// Both passes fold the tiles of a sub-chunk through this function in the
// same order, so they see the same b to the bit.
__device__ __forceinline__ float gate_tile(const float* __restrict__ ig,
                                           const float* __restrict__ fg, size_t gate0, int NH,
                                           int S, int seq0, int lb, int r0, float carry,
                                           float& ba, float& bb, float& la, float& lb_) {
  const int lane = threadIdx.x & 31;
  const int ra = r0 + 2 * lane, rb = ra + 1;
  float fa = 0.f, fb = 0.f;
  la = lb_ = -CUDART_INF_F;
  if (ra < lb && seq0 + ra < S) {
    fa = log_sigmoid(fg[gate0 + (size_t)(seq0 + ra) * NH]);
    la = log_sigmoid(ig[gate0 + (size_t)(seq0 + ra) * NH]);
  }
  if (rb < lb && seq0 + rb < S) {
    fb = log_sigmoid(fg[gate0 + (size_t)(seq0 + rb) * NH]);
    lb_ = log_sigmoid(ig[gate0 + (size_t)(seq0 + rb) * NH]);
  }
  float incl = fa + fb;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float b0 = excl + fa;
  const float b1 = b0 + fb;
  ba = carry + b0;
  bb = carry + b1;
  // the carry out is b of the tile's last valid row, to the bit: a sub-chunk's
  // log decay g then equals b of its last row, and a = (g - b) + logsig(i)
  // is exactly logsig(i) there, as in the JAX packing (b_rel[Lb-1] - b_rel)
  const int nv = min(min(lb, S - seq0) - r0, R);  // valid rows of the tile
  if (nv <= 0) return carry;
  const int rl = nv - 1;
  return carry + __shfl_sync(0xffffffffu, (rl & 1) ? b1 : b0, rl >> 1);
}

// ---------------------------------------------------------------------------
// state pass
// ---------------------------------------------------------------------------

template <typename T, typename CT, int DH>
__global__ void __launch_bounds__(NT) fw3_states_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ ig,
    const float* __restrict__ fg, const float* __restrict__ c0, const float* __restrict__ n0,
    float* __restrict__ c_scr, float* __restrict__ n_scr, float* __restrict__ cstates,
    float* __restrict__ c_last, float* __restrict__ n_last, int S, int NH, int NS, int NB,
    int Lb) {
  constexpr int TD = DH < 32 ? DH : 32;  // the block's tile of C: TD x TD
  constexpr int VPT = TD * TD / NT;      // C entries a thread: 1 or 4
  constexpr int TPR = TD / VPT;          // threads a C row
  constexpr int TILES = DH / TD;
  constexpr int VE = 16 / sizeof(T);  // elements a 16-byte load
  constexpr int VPR = TD / VE;        // 16-byte loads a tile row
  static_assert(TD * TD == VPT * NT, "one or four C entries a thread");

  __shared__ float sk[R][TD + 1];              // k, float32
  __shared__ __align__(16) float sv[R][TD];    // v, rounded to CT
  __shared__ float sea[R];                     // e^a
  __shared__ float stot;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / NH;
  const int hd = bh - b * NH;
  const int tk = blockIdx.y / TILES, tv = blockIdx.y - tk * TILES;
  const int dk = tid / TPR, dv0 = (tid % TPR) * VPT;
  const int row = tk * TD + dk, col0 = tv * TD + dv0;  // this thread's C[row][col0 + x]
  const bool owns_n = tv == 0 && dv0 == 0;
  const int H = NH * DH;
  const size_t base = (size_t)b * S * H + (size_t)hd * DH;
  const size_t gate0 = (size_t)b * S * NH + hd;
  const int NC = NS / NB;
  const int RT = (Lb + R - 1) / R;

  float c[VPT];
  const size_t cst0 = (size_t)bh * DH * DH + (size_t)row * DH + col0;
#pragma unroll
  for (int x = 0; x < VPT; ++x) c[x] = c0 ? c0[cst0 + x] : 0.f;
  float n = (owns_n && n0) ? n0[(size_t)bh * DH + row] : 0.f;

  for (int s = 0; s < NS; ++s) {
    const int seq0 = s * Lb;
    // the state before sub-chunk s
    const size_t st = ((size_t)b * NS + s) * NH + hd;
#pragma unroll
    for (int x = 0; x < VPT; ++x) c_scr[st * DH * DH + (size_t)row * DH + col0 + x] = c[x];
    if (owns_n) n_scr[st * DH + row] = n;
    if (cstates && s % NB == 0) {
      const size_t ch = ((size_t)b * NC + s / NB) * NH + hd;
#pragma unroll
      for (int x = 0; x < VPT; ++x) cstates[ch * DH * DH + (size_t)row * DH + col0 + x] = c[x];
    }

    // the sub-chunk's log decay g = b_last (one warp folds its tiles)
    if (tid < 32) {
      float carry = 0.f, ba, bb, la, lb_;
      for (int t = 0; t < RT; ++t)
        carry = gate_tile(ig, fg, gate0, NH, S, seq0, Lb, t * R, carry, ba, bb, la, lb_);
      if (tid == 0) stot = carry;
    }
    __syncthreads();
    const float tot = stot;

    float acc[VPT];
#pragma unroll
    for (int x = 0; x < VPT; ++x) acc[x] = 0.f;
    float nacc = 0.f;
    float carry = 0.f;  // warp 0's running sum of the tiles before
    for (int t = 0; t < RT; ++t) {
      const int r0 = t * R;
      if (tid < 32) {
        float ba, bb, la, lb_;
        carry = gate_tile(ig, fg, gate0, NH, S, seq0, Lb, r0, carry, ba, bb, la, lb_);
        sea[2 * tid] = expf((tot - ba) + la);
        sea[2 * tid + 1] = expf((tot - bb) + lb_);
      }
      for (int e = tid; e < R * VPR; e += NT) {
        const int r = e / VPR;
        const int col = (e - r * VPR) * VE;
        float kv[VE], vv[VE];
        if (r0 + r < Lb && seq0 + r0 + r < S) {
          const size_t off = base + (size_t)(seq0 + r0 + r) * H;
          load16(k + off + tk * TD + col, kv);
          load16(v + off + tv * TD + col, vv);
        } else {
#pragma unroll
          for (int j = 0; j < VE; ++j) kv[j] = vv[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < VE; ++j) {
          sk[r][col + j] = kv[j];
          sv[r][col + j] = rt<CT>(vv[j]);
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int r = 0; r < R; ++r) {
        const float kb = sk[r][dk] * sea[r];  // k e^a, float32
        nacc += kb;
        const float kr = rt<CT>(kb);
#pragma unroll
        for (int x = 0; x < VPT; ++x) acc[x] = fmaf(kr, sv[r][dv0 + x], acc[x]);
      }
      __syncthreads();
    }
    const float gbar = expf(tot);
#pragma unroll
    for (int x = 0; x < VPT; ++x) c[x] = fmaf(gbar, c[x], acc[x]);
    n = fmaf(gbar, n, nacc);
  }

#pragma unroll
  for (int x = 0; x < VPT; ++x) c_last[cst0 + x] = c[x];
  if (owns_n) n_last[(size_t)bh * DH + row] = n;
}

// ---------------------------------------------------------------------------
// output pass
// ---------------------------------------------------------------------------

// The block's shared memory.  Row lengths are multiples of 16 bytes, so
// the float4 reads below stay aligned.
template <int DH>
struct __align__(16) OutSmem {
  float sqT[DH][RP];    // q transposed, float32
  float skT[DH][RP];    // k transposed, rounded to CT
  float sv[R][DH];      // v, rounded to CT
  float ssd[R][R + 1];  // causal s * D
  float sbr[R];         // b of the block's rows
  float sbc[R];         // b of the column tile
  float slc[R];         // logsig(i) of the column tile
};

template <typename T, typename CT, int DH>
__global__ void __launch_bounds__(NT) fw3_out_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ ig, const float* __restrict__ fg, const float* __restrict__ c_scr,
    const float* __restrict__ n_scr, T* __restrict__ h, float* __restrict__ n_out, int S,
    int NH, int NS, int NB, int Lb, int L, float qk_scale, float eps) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int VPR = DH / VE;
  constexpr int G4 = DH / 16;  // groups of 4 columns a thread: columns 4 (p + 4 m) + 0..3
  extern __shared__ __align__(16) unsigned char out_smem[];
  OutSmem<DH>& sm = *reinterpret_cast<OutSmem<DH>*>(out_smem);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / NH;
  const int hd = bh - b * NH;
  const int s = blockIdx.y;  // sub-chunk
  const int t = blockIdx.z;  // row tile of the sub-chunk
  const int seq0 = s * Lb;
  const int H = NH * DH;
  const size_t base = (size_t)b * S * H + (size_t)hd * DH;
  const size_t gate0 = (size_t)b * S * NH + hd;

  // q tile, transposed; b of the rows (warp 0 folds the tiles before)
  for (int e = tid; e < R * VPR; e += NT) {
    const int r = e / VPR;
    const int col = (e - r * VPR) * VE;
    const int rr = t * R + r;
    float qv[VE];
    if (rr < Lb && seq0 + rr < S) {
      load16(q + base + (size_t)(seq0 + rr) * H + col, qv);
    } else {
#pragma unroll
      for (int j = 0; j < VE; ++j) qv[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VE; ++j) sm.sqT[col + j][r] = qv[j];
  }
  if (tid < 32) {
    float carry = 0.f, ba, bb, la, lb_;
    for (int jt = 0; jt < t; ++jt)
      carry = gate_tile(ig, fg, gate0, NH, S, seq0, Lb, jt * R, carry, ba, bb, la, lb_);
    gate_tile(ig, fg, gate0, NH, S, seq0, Lb, t * R, carry, ba, bb, la, lb_);
    sm.sbr[2 * tid] = ba;
    sm.sbr[2 * tid + 1] = bb;
  }

  const int l = tid / 4;  // this thread's row of the tile
  const int p = tid % 4;  // and its column groups 4 (p + 4 m)
  float hi[G4 * 4];       // sd v
#pragma unroll
  for (int x = 0; x < G4 * 4; ++x) hi[x] = 0.f;
  float n_intra = 0.f;

  float carry = 0.f;  // warp 0's running sum of the column tiles before
  for (int jt = 0; jt <= t; ++jt) {
    const bool diag = jt == t;
    if (tid < 32) {
      float ba, bb, la, lb_;
      carry = gate_tile(ig, fg, gate0, NH, S, seq0, Lb, jt * R, carry, ba, bb, la, lb_);
      sm.sbc[2 * tid] = ba;
      sm.sbc[2 * tid + 1] = bb;
      sm.slc[2 * tid] = la;
      sm.slc[2 * tid + 1] = lb_;
    }
    for (int e = tid; e < R * VPR; e += NT) {
      const int r = e / VPR;
      const int col = (e - r * VPR) * VE;
      const int rr = jt * R + r;
      float kv[VE], vv[VE];
      if (rr < Lb && seq0 + rr < S) {
        const size_t off = base + (size_t)(seq0 + rr) * H + col;
        load16(k + off, kv);
        load16(v + off, vv);
      } else {
#pragma unroll
        for (int j = 0; j < VE; ++j) kv[j] = vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VE; ++j) {
        sm.skT[col + j][r] = rt<CT>(kv[j]);
        sm.sv[r][col + j] = rt<CT>(vv[j]);
      }
    }
    __syncthreads();

    // causal s * D, one 4x4 tile a thread (tiles above the diagonal zeroed)
    {
      const int ti = tid / 16, tj = tid % 16;
      if (!diag || tj <= ti) {
        float acc[4][4] = {};
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
          const float4 qa = *reinterpret_cast<const float4*>(&sm.sqT[d][ti * 4]);
          const float4 kb = *reinterpret_cast<const float4*>(&sm.skT[d][tj * 4]);
          const float qr[4] = {rt<CT>(qa.x), rt<CT>(qa.y), rt<CT>(qa.z), rt<CT>(qa.w)};
          const float kr[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(qr[r], kr[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int lr = ti * 4 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int lc = tj * 4 + c;
            // the exponent is masked before exp: b_l - b_j > 0 above the diagonal
            sm.ssd[lr][lc] = (!diag || lc <= lr)
                                 ? (acc[r][c] * qk_scale) *
                                       expf((sm.sbr[lr] - sm.sbc[lc]) + sm.slc[lc])
                                 : 0.f;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sm.ssd[ti * 4 + r][tj * 4 + c] = 0.f;
      }
    }
    __syncthreads();

    // sd v and rowsum sd for row l
    {
      const int jmax = diag ? l + 1 : R;
      for (int j = 0; j < jmax; ++j) {
        const float sd = sm.ssd[l][j];
        n_intra += sd;
        const float sr = rt<CT>(sd);
#pragma unroll
        for (int m = 0; m < G4; ++m) {
          const float4 vv = *reinterpret_cast<const float4*>(&sm.sv[j][4 * (p + 4 * m)]);
          hi[4 * m] = fmaf(sr, vv.x, hi[4 * m]);
          hi[4 * m + 1] = fmaf(sr, vv.y, hi[4 * m + 1]);
          hi[4 * m + 2] = fmaf(sr, vv.z, hi[4 * m + 2]);
          hi[4 * m + 3] = fmaf(sr, vv.w, hi[4 * m + 3]);
        }
      }
    }
    __syncthreads();
  }

  // the inter part: (q e^b qk_scale) C_s and its n term
  const size_t st = ((size_t)b * NS + s) * NH + hd;
  const float* __restrict__ C = c_scr + st * DH * DH;
  const float* __restrict__ nst = n_scr + st * DH;
  const float eb = expf(sm.sbr[l]);
  float he[G4 * 4];
#pragma unroll
  for (int x = 0; x < G4 * 4; ++x) he[x] = 0.f;
  float n_inter = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    const float qb = (sm.sqT[d][l] * eb) * qk_scale;
    n_inter = fmaf(qb, __ldg(nst + d), n_inter);
    const float qr = rt<CT>(qb);
#pragma unroll
    for (int m = 0; m < G4; ++m) {
      const float4 cv = __ldg(reinterpret_cast<const float4*>(C + (size_t)d * DH + 4 * (p + 4 * m)));
      he[4 * m] = fmaf(qr, rt<CT>(cv.x), he[4 * m]);
      he[4 * m + 1] = fmaf(qr, rt<CT>(cv.y), he[4 * m + 1]);
      he[4 * m + 2] = fmaf(qr, rt<CT>(cv.z), he[4 * m + 2]);
      he[4 * m + 3] = fmaf(qr, rt<CT>(cv.w), he[4 * m + 3]);
    }
  }

  const int rr = t * R + l;  // row of the sub-chunk
  if (rr >= Lb) return;
  const float den = fmaxf(fabsf(n_inter + n_intra), 1.f);
  if (n_out && p == 0) {
    const int NC = NS / NB;
    const size_t ch = ((size_t)b * NC + s / NB) * NH + hd;
    n_out[ch * L + (size_t)(s % NB) * Lb + rr] = den;
  }
  if (seq0 + rr >= S) return;
  T* hrow = h + base + (size_t)(seq0 + rr) * H;
  const float dn = den + eps;
#pragma unroll
  for (int m = 0; m < G4; ++m) {
    float o[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) o[x] = (he[4 * m + x] + hi[4 * m + x]) / dn;
    store4(hrow + 4 * (p + 4 * m), o);
  }
}

template <typename T, typename CT, int DH>
int launch_states(const void* k, const void* v, const float* i, const float* f, const float* c0,
                  const float* n0, float* c_scr, float* n_scr, float* cstates, float* c_last,
                  float* n_last, int B, int S, int NH, int L, int Lb, cudaStream_t st) {
  constexpr int TD = DH < 32 ? DH : 32;
  const int NB = L / Lb;
  const int NS = ((S + L - 1) / L) * NB;
  dim3 grid(B * NH, (DH / TD) * (DH / TD));
  fw3_states_kernel<T, CT, DH><<<grid, NT, 0, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), i, f, c0, n0, c_scr, n_scr, cstates,
      c_last, n_last, S, NH, NS, NB, Lb);
  return (int)cudaGetLastError();
}

template <typename T, typename CT, int DH>
int launch_out(const void* q, const void* k, const void* v, const float* i, const float* f,
               const float* c_scr, const float* n_scr, void* h, float* n_out, int B, int S,
               int NH, int L, int Lb, float qk_scale, float eps, cudaStream_t st) {
  const int NB = L / Lb;
  const int NS = ((S + L - 1) / L) * NB;
  dim3 grid(B * NH, NS, (Lb + R - 1) / R);
  return port::launch_with_smem(fw3_out_kernel<T, CT, DH>, grid, sizeof(OutSmem<DH>), st,
                                static_cast<const T*>(q), static_cast<const T*>(k),
                                static_cast<const T*>(v), i, f, c_scr, n_scr, static_cast<T*>(h),
                                n_out, S, NH, NS, NB, Lb, L, qk_scale, eps);
}

}  // namespace

// The state pass.  dtype and cdtype (the storage and the compute type):
// 0 = float32, 1 = bfloat16.  c0/n0 may be null (zero initial state),
// cstates null (inference, or one sub-chunk a chunk: c_scr is then the
// states).  c_scr (B, NS, NH, DH, DH) and n_scr (B, NS, NH, DH) float32,
// NS = ceil(S / L) * (L / Lb); Lb divides L.  Returns the CUDA error code of
// the launch; 1000 for an unsupported dtype or head size (the Python
// wrapper checks both before calling).
extern "C" int fw3_states(const void* k, const void* v, const float* i, const float* f,
                          const float* c0, const float* n0, float* c_scr, float* n_scr,
                          float* cstates, float* c_last, float* n_last, int B, int S, int NH,
                          int DH, int L, int Lb, int dtype, int cdtype, void* stream) {
  return port::dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dh) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dh)::value;
    return launch_states<T, CT, D>(k, v, i, f, c0, n0, c_scr, n_scr, cstates, c_last, n_last,
                                   B, S, NH, L, Lb, static_cast<cudaStream_t>(stream));
  });
}

// The output pass, after fw3_states on the same stream: h (B, S, NH*DH) in
// the storage type; n_out (B, NC, NH, L) float32 or null (inference).
extern "C" int fw3_out(const void* q, const void* k, const void* v, const float* i,
                       const float* f, const float* c_scr, const float* n_scr, void* h,
                       float* n_out, int B, int S, int NH, int DH, int L, int Lb, int dtype,
                       int cdtype, float qk_scale, float eps, void* stream) {
  return port::dispatch(dtype, cdtype, DH, [&](auto t, auto ct, auto dh) -> int {
    using T = decltype(t);
    using CT = decltype(ct);
    constexpr int D = decltype(dh)::value;
    return launch_out<T, CT, D>(q, k, v, i, f, c_scr, n_scr, h, n_out, B, S, NH, L, Lb,
                                qk_scale, eps, static_cast<cudaStream_t>(stream));
  });
}
