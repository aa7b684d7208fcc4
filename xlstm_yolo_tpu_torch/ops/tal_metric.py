"""The fused metric stage of the task-aligned assigner: the CUDA kernel, its
wrapper and its plain PyTorch version.

Counterpart of ``xlstm_yolo_tpu/ops/pallas/tal_metric.py``
(``tal_metric_pallas`` :116, ``_kernel`` :39): steps 1-3 of
:func:`~xlstm_yolo_tpu_torch.utils.tal.task_aligned_assign` in one launch,
kernel ``tal_metric`` in ``csrc/tal_metric.cu``:

1. the strict in-box mask of each anchor centre in each gt, with ``mask_gt``;
2. CIoU(gt, pred), clamped at 0 and masked, with each box's ``atan(w / h)``
   (a torch op in the plain version, as the JAX wrapper computes it; the
   same quotient and ``atanf``, the function that op calls on the card, in
   the kernel);
3. the gt's class score, ``align = sqrt(s) * ((ov2 * ov2) * ov2)`` with
   ``ov2 = ov * ov`` (alpha 0.5, beta 6 fixed), and the top-k anchors of
   each gt as ``topk`` rounds of row max with the lowest index among ties,
   round r counting only where ``r < topk_arr[b]``.

:func:`tal_metric_plain` follows the Pallas kernel's expression operation
for operation, so the kernel, whose arithmetic is rounded operation by
operation too, gives the same bits.  :func:`tal_metric` launches the kernel
for CUDA tensors (or raises) and runs the plain version for CPU tensors;
its host side casts only operands not already in the kernel's types.  The
kernel takes a row of the (B, M) gts as a thread-block cluster of
:func:`cluster_size` CTAs.  Forward only, as in JAX: the assigner runs
without gradient.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from xlstm_yolo_tpu_torch.ops import cuda_build
from xlstm_yolo_tpu_torch.ops.cuda_build import F, I, P

__all__ = ["LAUNCHES", "cluster_size", "tal_metric", "tal_metric_plain"]

LAUNCHES = 0  # launches of the metric-stage kernel

EPS_IOU = 1e-7  # bbox_iou's eps
_4_PI2 = 4.0 / math.pi ** 2
f32 = torch.float32


def _declare(lib):
    lib.tal_metric.argtypes = [P] * 10 + [I] * 7 + [F] * 4 + [P]
    lib.tal_metric.restype = I


def cluster_size(rows: int) -> int:
    """CTAs a row's cluster, each a slice of the anchors: the fewest of 1,
    2, 4 and 8 that make at least ``CLUSTER_FILL`` CTAs in all, so that few
    rows (B 8, M 8: 64) still spread over the card's 132 SMs.  Each CTA
    more a row adds a level to the merge of the row's top-k; on an H100 at
    640 px, B 8, topk 10, 4 CTAs a row took the least time at M 8 and 1 at
    M 128 (PERF.md §6, the TAL metric's row)."""
    n = 1
    while n < 8 and rows * n < CLUSTER_FILL:
        n *= 2
    return n


CLUSTER_FILL = 256  # CTAs a launch aims at: about two an SM


def _check_shapes(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt):
    B, A, nc = pd_scores.shape
    M = gt_bboxes.shape[1]
    if pd_bboxes.shape != (B, A, 4) or anc_points.shape != (A, 2):
        raise ValueError(f"pd_bboxes must be (B, A, 4) and anc_points (A, 2), got "
                         f"{tuple(pd_bboxes.shape)} and {tuple(anc_points.shape)}")
    if gt_bboxes.shape != (B, M, 4) or gt_labels.shape != (B, M) or mask_gt.shape != (B, M):
        raise ValueError("gt_bboxes must be (B, M, 4), gt_labels and mask_gt (B, M)")
    return B, M, A, nc


def _as(t, dtype):
    """t in dtype, contiguous: t itself where it already is (no torch op)."""
    if t.dtype != dtype:
        t = t.to(dtype)
    return t if t.is_contiguous() else t.contiguous()


def _prepare(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, topk, topk_arr,
             num_classes):
    """The plain version's operands: float32, the atan terms of both box
    sets (one torch op each, as the JAX wrapper computes them), the clipped
    class index and the per-sample k."""
    B, M, A, nc = _check_shapes(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt)
    pb = pd_bboxes.to(f32).contiguous()
    gb = gt_bboxes.to(f32).contiguous()
    atan_p = torch.atan((pb[..., 2] - pb[..., 0]) / (pb[..., 3] - pb[..., 1] + EPS_IOU))
    atan_g = torch.atan((gb[..., 2] - gb[..., 0]) / (gb[..., 3] - gb[..., 1] + EPS_IOU))
    cls = gt_labels.to(torch.int32).clamp(0, num_classes - 1).contiguous()
    if topk_arr is None:
        k = torch.full((B,), topk, dtype=torch.int32, device=pd_scores.device)
    else:
        k = torch.as_tensor(topk_arr, device=pd_scores.device).to(torch.int32).reshape(B)
    return (pd_scores.to(f32).contiguous(), pb, anc_points.to(f32).contiguous(),
            cls, gb, mask_gt.bool().contiguous(), atan_p.contiguous(), atan_g.contiguous(),
            k.contiguous())


def tal_metric_plain(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
                     topk: int = 10, num_classes: int = 80, eps: float = 1e-9, topk_arr=None):
    """Plain PyTorch version of the kernel: the Pallas kernel's expressions
    in its order over the (B, M, A) grid.  Same interface as
    :func:`tal_metric`."""
    scores, pb, anc, cls, gb, mgt, atan_p, atan_g, k = _prepare(
        pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, topk, topk_arr,
        num_classes)
    B, A, nc = scores.shape
    M = gb.shape[1]
    ax, ay = anc[:, 0][None, None], anc[:, 1][None, None]  # (1, 1, A)
    px1, py1, px2, py2 = (pb[..., j][:, None, :] for j in range(4))  # (B, 1, A)
    gx1, gy1, gx2, gy2 = (gb[..., j][..., None] for j in range(4))  # (B, M, 1)

    mask_in = (ax - gx1 > eps) & (ay - gy1 > eps) & (gx2 - ax > eps) & (gy2 - ay > eps)
    valid = mask_in & mgt[..., None]

    w1 = gx2 - gx1
    h1 = gy2 - gy1 + EPS_IOU
    w2 = px2 - px1
    h2 = py2 - py1 + EPS_IOU
    iw = torch.clamp(torch.minimum(gx2, px2) - torch.maximum(gx1, px1), min=0.0)
    ih = torch.clamp(torch.minimum(gy2, py2) - torch.maximum(gy1, py1), min=0.0)
    inter = iw * ih
    union = w1 * h1 + w2 * h2 - inter + EPS_IOU
    iou = inter / union
    cw = torch.maximum(gx2, px2) - torch.minimum(gx1, px1)
    ch = torch.maximum(gy2, py2) - torch.minimum(gy1, py1)
    c2 = cw * cw + ch * ch + EPS_IOU
    dx = px1 + px2 - gx1 - gx2
    dy = py1 + py2 - gy1 - gy2
    rho2 = (dx * dx + dy * dy) * 0.25
    dv = atan_p[:, None, :] - atan_g[..., None]
    v = _4_PI2 * (dv * dv)
    alpha_t = v / (v - iou + (1.0 + EPS_IOU))
    ciou = iou - (rho2 / c2 + v * alpha_t)
    zero = torch.zeros((), dtype=f32, device=scores.device)
    overlaps = torch.where(valid, torch.clamp(ciou, min=0.0), zero)

    # the class score: a gather (the Pallas kernel's one-hot product has one
    # non-zero term); a label beyond the scores' classes scores 0
    s_cls = scores.transpose(1, 2).gather(1, cls.clamp(max=nc - 1).long()[..., None].expand(B, M, A))
    s_cls = torch.where((cls < nc)[..., None], s_cls, zero)
    bbox_scores = torch.where(valid, s_cls, zero)
    ov2 = overlaps * overlaps
    align = torch.sqrt(bbox_scores) * (ov2 * ov2 * ov2)

    iota = torch.arange(A, device=scores.device)
    live = align
    sel = torch.zeros(B, M, A, dtype=torch.bool, device=scores.device)
    counts = k[:, None, None]
    for r in range(topk):
        rowmax = live.amax(-1, keepdim=True)
        idx = torch.where(live == rowmax, iota, A).amin(-1, keepdim=True)
        oh = iota == idx
        sel |= oh & (r < counts)
        live = torch.where(oh, float("-inf"), live)
    return align, overlaps, sel & valid


def tal_metric(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
               topk: int = 10, num_classes: int = 80, eps: float = 1e-9, topk_arr=None):
    """Fused steps 1-3 of the task-aligned assigner.

    pd_scores (B, A, nc) sigmoid probabilities; pd_bboxes (B, A, 4) and
    gt_bboxes (B, M, 4) xyxy in image units (gts padded with zeros);
    anc_points (A, 2) in image units; gt_labels (B, M) ints; mask_gt (B, M)
    validity; ``topk_arr`` an optional per-sample k (B,) <= ``topk``.
    Returns (align_metric, overlaps, mask_pos), each (B, M, A): float32,
    float32 and bool, mask_pos being the top-k of a valid gt's in-box
    anchors.

    CUDA tensors go through the hand-written kernel (or this raises); CPU
    tensors go through :func:`tal_metric_plain`.
    """
    global LAUNCHES
    if pd_scores.device.type == "cpu":
        return tal_metric_plain(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
                                topk=topk, num_classes=num_classes, eps=eps, topk_arr=topk_arr)
    if pd_scores.device.type != "cuda":
        raise ValueError(f"unsupported device {pd_scores.device}")
    B, M, A, nc = _check_shapes(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt)
    karr = None
    if topk_arr is not None:
        karr = _as(torch.as_tensor(topk_arr, device=pd_scores.device), torch.int32).reshape(B)
    ops = (_as(pd_scores, f32), _as(pd_bboxes, f32), _as(anc_points, f32),
           _as(gt_labels, torch.int32), _as(gt_bboxes, f32), _as(mask_gt, torch.bool), karr)
    cuda_build.check_kernel_inputs(*ops)
    dev = pd_scores.device
    align = torch.empty(B, M, A, dtype=f32, device=dev)
    overlaps = torch.empty_like(align)
    mask_pos = torch.empty(B, M, A, dtype=torch.bool, device=dev)
    if B * M * A == 0:
        return align, overlaps, mask_pos.fill_(False)
    lib = cuda_build.load("tal_metric", _declare)
    cuda_build.launch_on(lib.tal_metric, "tal_metric",
                         dev.index if dev.index is not None else torch.cuda.current_device(),
                         *cuda_build.pointers(*ops, align, overlaps, mask_pos),
                         B, M, A, nc, int(num_classes), int(topk), cluster_size(B * M),
                         float(eps), EPS_IOU, _4_PI2, 1.0 + EPS_IOU)
    LAUNCHES += 1
    return align, overlaps, mask_pos
