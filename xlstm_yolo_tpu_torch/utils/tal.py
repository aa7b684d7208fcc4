"""Anchor geometry and the task-aligned assigner (counterpart of
``make_anchors``, ``dist2bbox``, ``bbox2dist``, ``topk_select_mask``,
``task_aligned_assign``, ``task_aligned_assign_pallas_metric`` and
``_assign_from_metric`` in ``xlstm_yolo_tpu/utils/tal.py``): fixed shapes,
padded gts, every step a masked dense computation over the (B, M, A) grid."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from xlstm_yolo_tpu_torch.ops.tal_metric import tal_metric
from xlstm_yolo_tpu_torch.utils.metrics import bbox_iou
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

f32 = torch.float32


def make_anchors(feat_shapes: Sequence[tuple[int, int]], strides: Sequence[float],
                 grid_cell_offset: float = 0.5, device=None):
    """Anchor centres (A, 2) in feature units and strides (A, 1)."""
    points, stride_list = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=f32, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=f32, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        stride_list.append(torch.full((h * w, 1), float(s), dtype=f32, device=device))
    return torch.cat(points), torch.cat(stride_list)


def dist2bbox(distance, anchor_points, xywh: bool = True, dim: int = -1):
    """ltrb distances -> boxes (xywh or xyxy)."""
    lt, rb = distance.chunk(2, dim=dim)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=dim)
    return torch.cat([x1y1, x2y2], dim=dim)


def bbox2dist(anchor_points, bbox, reg_max: float):
    """xyxy boxes -> ltrb distances, clamped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    d = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1)
    return d.clamp(0, reg_max - 0.01)


def topk_select_mask(metric: torch.Tensor, topk: int, k_arr=None) -> torch.Tensor:
    """(..., A) metric -> (..., A) bool mask of its ``topk`` largest
    entries, as ``topk`` masked-argmax rounds: value ties go to the lowest
    index first (``argmax`` returns the first maximum; ``torch.topk`` on
    CUDA promises no order among ties), and a chosen entry is masked to
    -inf so the indices are distinct.

    ``k_arr`` (one int <= ``topk`` per leading index) is a per-sample k:
    round r counts for sample b only where r < k_arr[b] (the E2E loss's
    top-10 and top-1 halves in one call)."""
    A = metric.shape[-1]
    live = metric.to(acc_dtype(metric.dtype))
    sel = torch.zeros(metric.shape, dtype=torch.bool, device=metric.device)
    if k_arr is not None:
        k_arr = torch.as_tensor(k_arr, device=metric.device).reshape(
            (metric.shape[0],) + (1,) * (metric.ndim - 1))
    for r in range(topk):
        oh = F.one_hot(live.argmax(-1), A).bool()
        sel |= oh if k_arr is None else oh & (r < k_arr)
        live = live.masked_fill(oh, float("-inf"))
    return sel


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (B, A) int32
    target_bboxes: torch.Tensor  # (B, A, 4)
    target_scores: torch.Tensor  # (B, A, nc)
    fg_mask: torch.Tensor        # (B, A) bool
    target_gt_idx: torch.Tensor  # (B, A) int64


def task_aligned_assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt,
                        topk: int = 10, num_classes: int = 80, alpha: float = 0.5,
                        beta: float = 6.0, eps: float = 1e-9, topk_arr=None) -> AssignResult:
    """Assign padded gts to anchors by s^alpha * CIoU^beta, masked dense over
    the (B, M, A) grid.

    pd_scores (B, A, nc) sigmoid probabilities; pd_bboxes (B, A, 4) and
    gt_bboxes (B, M, 4) xyxy in image units; anc_points (A, 2) in image
    units; gt_labels (B, M) ints; mask_gt (B, M) validity; ``topk_arr`` an
    optional per-sample k (B,) <= ``topk`` (:func:`topk_select_mask`).  An
    in-box anchor of a valid gt stays a top-k candidate even at zero metric.
    """
    B, A, nc = pd_scores.shape
    M = gt_bboxes.shape[1]
    mask_gt = mask_gt.bool()
    lt, rb = gt_bboxes[..., None, :2], gt_bboxes[..., None, 2:]
    deltas = torch.cat([anc_points[None, None] - lt, rb - anc_points[None, None]], dim=-1)
    valid = (deltas.amin(-1) > eps) & mask_gt[..., None]  # (B, M, A)

    cls_idx = gt_labels.long().clamp(0, nc - 1)
    bbox_scores = pd_scores.transpose(1, 2).gather(1, cls_idx[:, :, None].expand(B, M, A))
    bbox_scores = torch.where(valid, bbox_scores, torch.zeros_like(bbox_scores))
    ious = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], xywh=False, kind="ciou")
    overlaps = torch.where(valid, ious.clamp(min=0.0), torch.zeros_like(ious))
    acc = acc_dtype(overlaps.dtype)
    align_metric = bbox_scores.to(acc) ** alpha * overlaps.to(acc) ** beta

    mask_pos = topk_select_mask(align_metric, topk, topk_arr) & mask_gt[..., None] & valid
    return _assign_from_metric(align_metric, overlaps, mask_pos, gt_labels, gt_bboxes,
                               fg_eps=eps, num_classes=num_classes)


def task_aligned_assign_pallas_metric(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes,
                                      mask_gt, topk: int = 10, num_classes: int = 80,
                                      eps: float = 1e-9, topk_arr=None) -> AssignResult:
    """:func:`task_aligned_assign` (alpha 0.5, beta 6) with its metric stage
    fused into one kernel (:func:`~xlstm_yolo_tpu_torch.ops.tal_metric.tal_metric`),
    under the JAX package's name for the same entry.  The training step
    keeps :func:`task_aligned_assign`, as JAX does; this entry takes the
    kernel on CUDA tensors and its plain version on CPU tensors."""
    align_metric, overlaps, mask_pos = tal_metric(
        pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt.bool(), topk=topk,
        num_classes=num_classes, eps=eps, topk_arr=topk_arr)
    return _assign_from_metric(align_metric, overlaps, mask_pos, gt_labels, gt_bboxes,
                               fg_eps=eps, num_classes=num_classes)


def _assign_from_metric(align_metric, overlaps, mask_pos, gt_labels, gt_bboxes,
                        fg_eps: float, num_classes: int) -> AssignResult:
    """Resolve anchors claimed by several gts (highest IoU wins), gather the
    targets and scale the one-hot scores by the per-gt normalised metric."""
    B, M, A = mask_pos.shape
    multi = mask_pos.sum(-2) > 1  # (B, A)
    max_iou_gt = torch.where(mask_pos, overlaps, torch.full_like(overlaps, -1.0)).argmax(-2)
    is_max = F.one_hot(max_iou_gt, M).bool().transpose(1, 2)  # (B, M, A)
    mask_pos = torch.where(multi[:, None, :], is_max & mask_pos, mask_pos)
    fg_mask = mask_pos.any(-2)
    target_gt_idx = mask_pos.to(torch.int32).argmax(-2)  # first claiming gt; 0 where none

    tl = gt_labels.long().gather(1, target_gt_idx)
    target_labels = torch.where(fg_mask, tl, torch.full_like(tl, num_classes)).to(torch.int32)
    target_bboxes = gt_bboxes.gather(1, target_gt_idx[..., None].expand(B, A, 4))
    # one-hot as jax.nn.one_hot: a label outside [0, nc) gives a zero row
    classes = torch.arange(num_classes, device=tl.device)
    onehot = (tl.clamp(min=0)[..., None] == classes).to(align_metric.dtype)
    target_scores = torch.where(fg_mask[..., None], onehot, torch.zeros_like(onehot))

    am = align_metric * mask_pos
    pos_align = am.amax(-1, keepdim=True)
    pos_iou = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = ((am * pos_iou) / (pos_align + fg_eps)).amax(-2)  # (B, A)
    return AssignResult(target_labels, target_bboxes, target_scores * norm[..., None],
                        fg_mask, target_gt_idx)
