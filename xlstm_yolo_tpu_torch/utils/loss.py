"""Detection losses: BCE classification, CIoU box and DFL losses over a
task-aligned assignment, on padded targets.

Counterpart of ``LossItems``, ``_bce_logits``, ``_dfl_loss``,
``v8_detection_loss`` and ``e2e_detect_loss`` (the two-pass form) in
``xlstm_yolo_tpu/utils/loss.py``.  Targets are per-image padded arrays:
gt_labels (B, M) ints, gt_bboxes (B, M, 4) xyxy in image units, mask_gt
(B, M) validity.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from xlstm_yolo_tpu_torch.nn.head import dfl_decode
from xlstm_yolo_tpu_torch.utils.metrics import bbox_iou
from xlstm_yolo_tpu_torch.utils.tal import bbox2dist, dist2bbox, make_anchors, task_aligned_assign
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype


class LossItems(NamedTuple):
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def _bce_logits(logits, targets):
    """Elementwise binary cross-entropy with logits (no reduction)."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _dfl_loss(pred_dist, target, reg_max: int):
    """Distribution focal loss.  pred_dist (..., 4, reg_max) logits; target
    (..., 4) in [0, reg_max - 1); the mean over the 4 sides."""
    target = target.clamp(0, reg_max - 1 - 0.01)
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist.to(acc_dtype(pred_dist.dtype)), dim=-1)
    ce_l = -logp.gather(-1, tl[..., None])[..., 0]
    ce_r = -logp.gather(-1, tr.clamp(max=reg_max - 1)[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(-1)


def v8_detection_loss(feats: Sequence[torch.Tensor], gt_labels, gt_bboxes, mask_gt,
                      strides: Sequence[float], nc: int = 80, reg_max: int = 16,
                      tal_topk: int = 10, box_gain: float = 7.5, cls_gain: float = 0.5,
                      dfl_gain: float = 1.5):
    """One v8 detection loss over per-level (B, h, w, no) raw maps.
    Returns (total, LossItems); total is scaled by the batch size."""
    B = feats[0].shape[0]
    no = nc + reg_max * 4
    flat = torch.cat([f.reshape(B, -1, no) for f in feats], dim=1)  # (B, A, no)
    pred_distri, pred_scores = flat[..., : reg_max * 4], flat[..., reg_max * 4:]
    acc = acc_dtype(flat.dtype)
    anchor_points, stride_t = make_anchors([f.shape[1:3] for f in feats], strides, 0.5,
                                           device=flat.device)
    anchor_points, stride_t = anchor_points.to(acc), stride_t.to(acc)

    dist = dfl_decode(pred_distri, reg_max)
    pred_bboxes = dist2bbox(dist, anchor_points[None], xywh=False)  # (B, A, 4)
    assign = task_aligned_assign(
        torch.sigmoid(pred_scores.to(acc)).detach(), (pred_bboxes * stride_t[None]).detach(),
        anchor_points * stride_t, gt_labels, gt_bboxes.to(acc), mask_gt, topk=tal_topk,
        num_classes=nc, alpha=0.5, beta=6.0)
    target_scores = assign.target_scores
    target_bboxes = assign.target_bboxes / stride_t[None]
    fg = assign.fg_mask
    tss = target_scores.sum().clamp(min=1.0)

    loss_cls = _bce_logits(pred_scores.to(acc), target_scores).sum() / tss
    weight = target_scores.sum(-1) * fg
    iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, kind="ciou")
    iou = torch.where(fg, iou, torch.ones_like(iou))  # zero the metric, not the weight
    loss_box = ((1.0 - iou) * weight).sum() / tss
    target_ltrb = bbox2dist(anchor_points[None], target_bboxes, reg_max - 1)
    dfl = _dfl_loss(pred_distri.reshape(B, -1, 4, reg_max), target_ltrb, reg_max)
    loss_dfl = (torch.where(fg, dfl, torch.zeros_like(dfl)) * weight).sum() / tss

    items = LossItems(loss_box * box_gain, loss_cls * cls_gain, loss_dfl * dfl_gain)
    return (items.box + items.cls + items.dfl) * B, items


def e2e_detect_loss(preds: dict, gt_labels, gt_bboxes, mask_gt, strides, nc: int = 80, **kw):
    """one2many (top-10) + one2one (top-1) losses, summed."""
    l_m, it_m = v8_detection_loss(preds["one2many"], gt_labels, gt_bboxes, mask_gt, strides,
                                  nc=nc, tal_topk=10, **kw)
    l_o, it_o = v8_detection_loss(preds["one2one"], gt_labels, gt_bboxes, mask_gt, strides,
                                  nc=nc, tal_topk=1, **kw)
    return l_m + l_o, LossItems(*(a + b for a, b in zip(it_m, it_o)))
