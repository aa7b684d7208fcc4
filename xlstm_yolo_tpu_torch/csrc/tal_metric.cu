// Fused metric stage of the task-aligned assigner for Hopper, sm_90a.
//
// Replaces the TPU kernel `_kernel` (xlstm_yolo_tpu/ops/pallas/
// tal_metric.py:39, launched by `tal_metric_pallas` :116, call :167), with
// the atan terms its wrapper computes (:209, :217).  Per (image b, gt m),
// over the A anchors:
//
//   valid  = anchor centre strictly inside gt m (by more than eps) and mask_gt
//   ov     = valid ? max(CIoU(gt, pred), 0) : 0
//   align  = sqrt(valid ? score[b, a, cls[m]] : 0) * ((ov^2 * ov^2) * ov^2)
//   pos    = valid and a among the top-k of the row's align (by value, the
//            lowest index among ties; k = min(topk, k[b]); a NaN is never
//            taken)
//
// The CIoU follows the Pallas kernel's expression operation for operation,
// and every product, sum, quotient and root here is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn): nvcc would
// otherwise contract a*b + c into one FMA, and a metric one ulp away from
// the plain version's can flip a selection at the k-th place.  The atan
// terms atan(w / h) of both boxes are computed here, the quotient rounded
// as torch rounds it and atanf, the function torch.atan calls on the card.
//
// What bounds it.  Bytes: the three (B, M, A) outputs written once (77 MB
// at B 8, M 128, A 8400: 23 us at 3.35 TB/s), the scores gathered at the
// valid anchors, the boxes, anchors and gts read once; the ~80 operations
// an element are far below the card's rate.  The first design was 15x over
// this bound at M 8 and 2.8x at M 128: one 256-thread block a row (64
// blocks at B 8, M 8, under half the 132 SMs), and a top-k of k serial
// rounds, each re-scanning a 42 KB shared copy of the row with two block
// barriers.
//
// Design.  A row is a thread-block cluster of NC CTAs of 256 threads (NC up
// to 8 while the rows alone leave SMs idle, 1 when they fill the card; the
// wrapper's cluster_size: 4 at B 8, M 8), each CTA a slice of the
// anchors.  A thread walks its anchors in index order, writes align, overlaps
// and a zero mask_pos, and keeps its best KL (value, index) pairs in
// registers, sorted by value and then by the lower index.  Only an anchor
// inside the gt reads its box and score and computes the CIoU and atan
// (about 3 % of the (row, anchor) pairs at 640 px; the rest are 0, as the
// plain version's masks make them), and a padding gt's row is zeros.  Every
// element of the row's top-k is in its own thread's list, so merging the
// lists is exact: a warp merges its lanes' lists (k rounds of a warp arg-max
// over the list heads by two warp reductions, the winner popping its
// head), one warp
// the CTA's warps' lists, and one warp of CTA 0 the cluster's CTAs' lists,
// sent to its shared memory through distributed shared memory and a
// cluster barrier (with one CTA a row, the CTA's merge is the row's); it
// then marks mask_pos at the winners that are valid.
// No A-sized copy of the row is kept.  A topk above KL (16 at most) runs in
// rounds of KL: CTA 0 sends each CTA the last winner, and the next round's
// lists hold only what ranks below it, align read back from the row.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;        // threads of a CTA
constexpr int NW = NT / 32;    // its warps
constexpr int MAX_CLUSTER = 8;  // CTAs of a row at most (the portable cluster size)

// a ranks above b: the larger value, the lower index on a tie (a NaN never
// ranks above anything)
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// KL (value, index) pairs sorted best first; empty slots (-inf, INT_MAX)
// rank below every anchor.
template <int KL>
struct List {
  float v[KL];
  int i[KL];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      v[j] = -CUDART_INF_F;
      i[j] = INT_MAX;
    }
  }
  // (cv, ci) into its place, the last pair out; branch-free, so that every
  // slot stays a register (an early exit from the unrolled loop put the
  // lists in local memory)
  __device__ __forceinline__ void insert(float cv, int ci) {
    if (!better(cv, ci, v[KL - 1], i[KL - 1])) return;
    bool placed = false;
#pragma unroll
    for (int j = KL - 1; j > 0; --j) {
      const bool up = better(cv, ci, v[j - 1], i[j - 1]);  // it ranks above slot j - 1
      v[j] = placed ? v[j] : up ? v[j - 1] : cv;
      i[j] = placed ? i[j] : up ? i[j - 1] : ci;
      placed = placed || !up;
    }
    v[0] = placed ? v[0] : cv;
    i[0] = placed ? i[0] : ci;
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j + 1 < KL; ++j) {
      v[j] = v[j + 1];
      i[j] = i[j + 1];
    }
    v[KL - 1] = -CUDART_INF_F;
    i[KL - 1] = INT_MAX;
  }
  // slots [0, n) from (sv, si), the rest empty
  __device__ __forceinline__ void load(const float* sv, const int* si, int n) {
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      v[j] = j < n ? sv[j] : -CUDART_INF_F;
      i[j] = j < n ? si[j] : INT_MAX;
    }
  }
};

// v as an unsigned key in the order of float values (-inf lowest; the two
// zeros one key, as they compare equal); no list holds a NaN
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The best cnt (<= KL) of the 32 lanes' lists, best first: round r finds
// the largest head value by one warp reduction and the lowest index among
// the heads of that value by another (every lane gets both), its lane pops
// it, and out(r, value, index) runs on every lane.
template <int KL, typename Out>
__device__ __forceinline__ void warp_merge(List<KL>& l, int cnt, Out out) {
  for (int r = 0; r < cnt; ++r) {
    const unsigned kv = order_key(l.v[0]);
    const unsigned top = __reduce_max_sync(0xffffffffu, kv);
    const int bi = (int)__reduce_min_sync(0xffffffffu, kv == top ? (unsigned)l.i[0] : INT_MAX);
    const float bv = __shfl_sync(0xffffffffu, l.v[0], __ffs(__ballot_sync(0xffffffffu, kv == top)) - 1);
    if (l.i[0] == bi) l.pop();  // an index is in one list (empty slots pop harmlessly)
    out(r, bv, bi);
  }
}

template <int KL>
__global__ void __launch_bounds__(NT) tal_metric_kernel(
    const float* __restrict__ scores, const float* __restrict__ pbox,
    const float* __restrict__ anc, const int* __restrict__ labels,
    const float* __restrict__ gbox, const uint8_t* __restrict__ mask_gt,
    const int* __restrict__ karr, float* __restrict__ metric, float* __restrict__ overlaps,
    uint8_t* __restrict__ pos, int M, int A, int nc, int num_classes, int topk, float eps,
    float eps7, float four_pi2, float one_eps7) {
  __shared__ float w_v[NW][KL];  // each warp's best
  __shared__ int w_i[NW][KL];
  __shared__ float c_v[MAX_CLUSTER][KL];  // CTA 0: each CTA's best
  __shared__ int c_i[MAX_CLUSTER][KL];
  __shared__ float thr_v;  // the last winner of the round before
  __shared__ int thr_i;

  cg::cluster_group cluster = cg::this_cluster();
  const int ncta = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row = blockIdx.x / ncta;  // b * M + m
  const int b = static_cast<int>(row / M);
  const bool vec = A % 4 == 0;  // 4 anchors a step, 16-byte loads and stores
  const int slice = ((A + ncta - 1) / ncta + 3) / 4 * 4;
  const int a0 = min(A, rank * slice), a1 = min(A, a0 + slice);
  const float gx1 = gbox[row * 4 + 0], gy1 = gbox[row * 4 + 1];
  const float gx2 = gbox[row * 4 + 2], gy2 = gbox[row * 4 + 3];
  const bool gt_ok = mask_gt[row] != 0;
  const int c = min(max(labels[row], 0), num_classes - 1);
  const bool has_cls = c < nc;
  const float w1 = __fsub_rn(gx2, gx1);
  const float h1 = __fadd_rn(__fsub_rn(gy2, gy1), eps7);
  const float area1 = __fmul_rn(w1, h1);
  const float ag = atanf(__fdiv_rn(w1, h1));
  const size_t out0 = row * (size_t)A;
  const int k = min(topk, karr ? karr[b] : topk);
  auto inside = [&](float ax, float ay) {
    return gt_ok && __fsub_rn(ax, gx1) > eps && __fsub_rn(ay, gy1) > eps &&
           __fsub_rn(gx2, ax) > eps && __fsub_rn(gy2, ay) > eps;
  };
  // align and overlaps of a valid anchor from its box p and class score s
  auto metric_of = [&](float4 p, float s, float& al, float& ov) {
    const float px1 = p.x, py1 = p.y, px2 = p.z, py2 = p.w;
    const float w2 = __fsub_rn(px2, px1);
    const float h2 = __fadd_rn(__fsub_rn(py2, py1), eps7);
    const float iw = fmaxf(__fsub_rn(fminf(gx2, px2), fmaxf(gx1, px1)), 0.f);
    const float ih = fmaxf(__fsub_rn(fminf(gy2, py2), fmaxf(gy1, py1)), 0.f);
    const float inter = __fmul_rn(iw, ih);
    const float uni =
        __fadd_rn(__fsub_rn(__fadd_rn(area1, __fmul_rn(w2, h2)), inter), eps7);
    const float iou = __fdiv_rn(inter, uni);
    const float cw = __fsub_rn(fmaxf(gx2, px2), fminf(gx1, px1));
    const float ch = __fsub_rn(fmaxf(gy2, py2), fminf(gy1, py1));
    const float c2 = __fadd_rn(__fadd_rn(__fmul_rn(cw, cw), __fmul_rn(ch, ch)), eps7);
    const float dx = __fsub_rn(__fsub_rn(__fadd_rn(px1, px2), gx1), gx2);
    const float dy = __fsub_rn(__fsub_rn(__fadd_rn(py1, py2), gy1), gy2);
    const float rho2 = __fmul_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), 0.25f);
    const float dv = __fsub_rn(atanf(__fdiv_rn(w2, h2)), ag);
    const float v = __fmul_rn(four_pi2, __fmul_rn(dv, dv));
    const float alpha = __fdiv_rn(v, __fadd_rn(__fsub_rn(v, iou), one_eps7));
    const float ciou = __fsub_rn(iou, __fadd_rn(__fdiv_rn(rho2, c2), __fmul_rn(v, alpha)));
    ov = ciou < 0.f ? 0.f : ciou;  // clamp at 0 as torch.clamp does (a NaN stays NaN)
    const float ov2 = __fmul_rn(ov, ov);
    al = __fmul_rn(__fsqrt_rn(s), __fmul_rn(__fmul_rn(ov2, ov2), ov2));
  };
  const float4* pb4 = reinterpret_cast<const float4*>(pbox) + (size_t)b * A;
  const float* sc = scores + (size_t)b * A * nc + c;

  if (!gt_ok) {  // a padding gt: no anchor valid, every output 0
    for (int a = a0 + tid; a < a1; a += NT) {
      metric[out0 + a] = 0.f;
      overlaps[out0 + a] = 0.f;
      pos[out0 + a] = 0;
    }
    return;  // the whole cluster: one row, one gt
  }

  List<KL> best;
  best.clear();
  if (vec) {
    for (int a = a0 + 4 * tid; a < a1; a += 4 * NT) {
      const float4 xy01 = reinterpret_cast<const float4*>(anc)[a / 2];
      const float4 xy23 = reinterpret_cast<const float4*>(anc)[a / 2 + 1];
      const bool ok[4] = {inside(xy01.x, xy01.y), inside(xy01.z, xy01.w),
                          inside(xy23.x, xy23.y), inside(xy23.z, xy23.w)};
      float al[4] = {0.f, 0.f, 0.f, 0.f}, ov[4] = {0.f, 0.f, 0.f, 0.f};
      if (ok[0] || ok[1] || ok[2] || ok[3]) {  // masked anchors stay 0, as the plain where
        float4 p[4];
        float s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // every load of the step before any use
          p[u] = ok[u] ? pb4[a + u] : make_float4(0.f, 0.f, 0.f, 0.f);
          s[u] = ok[u] && has_cls ? sc[(size_t)(a + u) * nc] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (ok[u]) metric_of(p[u], s[u], al[u], ov[u]);
      }
      *reinterpret_cast<float4*>(metric + out0 + a) = make_float4(al[0], al[1], al[2], al[3]);
      *reinterpret_cast<float4*>(overlaps + out0 + a) = make_float4(ov[0], ov[1], ov[2], ov[3]);
      *reinterpret_cast<uint32_t*>(pos + out0 + a) = 0u;
#pragma unroll
      for (int u = 0; u < 4; ++u) best.insert(al[u], a + u);
    }
  } else {
    for (int a = a0 + tid; a < a1; a += NT) {
      const float2 an = reinterpret_cast<const float2*>(anc)[a];
      float al = 0.f, ov = 0.f;
      if (inside(an.x, an.y)) metric_of(pb4[a], has_cls ? sc[(size_t)a * nc] : 0.f, al, ov);
      metric[out0 + a] = al;
      overlaps[out0 + a] = ov;
      pos[out0 + a] = 0;
      best.insert(al, a);
    }
  }

  for (int done = 0; done < k; done += KL) {
    const int cnt = min(KL, k - done);
    const bool more = done + cnt < k;  // another round of KL after this one
    if (done > 0) {  // the next round: only what ranks below the last winner
      const float tv = thr_v;
      const int ti = thr_i;
      best.clear();
      for (int a = a0 + tid; a < a1; a += NT) {
        const float al = metric[out0 + a];  // this thread's own write
        if (better(tv, ti, al, a)) best.insert(al, a);
      }
    }
    warp_merge(best, cnt, [&](int r, float v, int i) {
      if (lane == 0) {
        w_v[warp][r] = v;
        w_i[warp][r] = i;
      }
    });
    __syncthreads();  // every warp's list is in; the row's zeros are written
    // the row's winners: mask_pos where valid, and the next round's threshold
    // to every CTA
    auto winners = [&](int r, float v, int i) {
      if (lane != 0) return;
      if (i < A) {
        const float2 an = reinterpret_cast<const float2*>(anc)[i];
        if (inside(an.x, an.y)) pos[out0 + i] = 1;
      }
      if (r == cnt - 1 && more)
        for (int q = 0; q < ncta; ++q) {
          *cluster.map_shared_rank(&thr_v, q) = v;
          *cluster.map_shared_rank(&thr_i, q) = i;
        }
    };
    if (warp == 0) {  // the CTA's best cnt: the row's with one CTA, else into CTA 0
      List<KL> l;
      l.load(w_v[lane % NW], w_i[lane % NW], lane < NW ? cnt : 0);
      if (ncta == 1) {
        warp_merge(l, cnt, winners);
      } else {
        float* dv = cluster.map_shared_rank(&c_v[rank][0], 0);
        int* di = cluster.map_shared_rank(&c_i[rank][0], 0);
        warp_merge(l, cnt, [&](int r, float v, int i) {
          if (lane == 0) {
            dv[r] = v;
            di[r] = i;
          }
        });
      }
    }
    if (ncta > 1) {
      cluster.sync();  // every CTA's list is in CTA 0, the row's zeros written
      if (rank == 0 && warp == 0) {
        List<KL> l;
        l.load(c_v[lane % MAX_CLUSTER], c_i[lane % MAX_CLUSTER], lane < ncta ? cnt : 0);
        warp_merge(l, cnt, winners);
      }
    }
    if (more) cluster.sync();  // the threshold is in; the lists are free again
  }
}

template <int KL>
int launch(int ncta, size_t rows, cudaStream_t st, const float* scores, const float* pbox,
           const float* anc, const int* labels, const float* gbox, const uint8_t* mask_gt,
           const int* karr, float* metric, float* overlaps, uint8_t* pos, int M, int A, int nc,
           int num_classes, int topk, float eps, float eps7, float four_pi2, float one_eps7) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * ncta));
  cfg.blockDim = dim3(NT);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, tal_metric_kernel<KL>, scores, pbox, anc, labels, gbox, mask_gt,
                         karr, metric, overlaps, pos, M, A, nc, num_classes, topk, eps, eps7,
                         four_pi2, one_eps7);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// scores (B, A, nc), pbox (B, A, 4), anc (A, 2), gbox (B, M, 4) float32;
// labels (B, M) int32 (clipped to [0, num_classes) here); mask_gt (B, M)
// bytes; karr (B) int32, or null for topk everywhere.  eps7, four_pi2 =
// 4 / pi^2 and one_eps7 = 1 + eps7 are the Python floats of the plain
// version rounded once to float32, as its torch ops round them.  ncta: the
// CTAs of a row's cluster, 1, 2, 4 or 8.  Outputs metric and overlaps (B,
// M, A) float32, pos (B, M, A) bytes.  Returns a CUDA error code; 1000 for
// shapes the kernel does not take.
extern "C" int tal_metric(const float* scores, const float* pbox, const float* anc,
                          const int* labels, const float* gbox, const uint8_t* mask_gt,
                          const int* karr, float* metric, float* overlaps, uint8_t* pos, int B,
                          int M, int A, int nc, int num_classes, int topk, int ncta, float eps,
                          float eps7, float four_pi2, float one_eps7, void* stream) {
  if (B <= 0 || M <= 0 || A <= 0 || nc <= 0 || num_classes <= 0) return 1000;
  if (ncta != 1 && ncta != 2 && ncta != 4 && ncta != MAX_CLUSTER) return 1000;
  const size_t rows = (size_t)B * M;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the list length: the topk's, up to 16 (a larger topk runs in rounds)
  const int kl = topk <= 1 ? 1 : topk <= 4 ? 4 : topk <= 10 ? 10 : 16;
  auto go = [&](auto klc) {
    return launch<decltype(klc)::value>(ncta, rows, st, scores, pbox, anc, labels, gbox,
                                        mask_gt, karr, metric, overlaps, pos, M, A, nc,
                                        num_classes, topk, eps, eps7, four_pi2, one_eps7);
  };
  switch (kl) {
    case 1: return go(std::integral_constant<int, 1>{});
    case 4: return go(std::integral_constant<int, 4>{});
    case 10: return go(std::integral_constant<int, 10>{});
    default: return go(std::integral_constant<int, 16>{});
  }
}
