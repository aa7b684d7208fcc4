"""Detection losses: BCE classification, CIoU box and DFL losses over a
task-aligned assignment, on padded targets; and the task losses built on
them: oriented boxes, classification, segmentation and pose.

Counterpart of ``LossItems``, ``_bce_logits``, ``_dfl_loss``,
``v8_detection_loss``, ``e2e_detect_loss`` (the two-pass form),
``v8_obb_loss``, ``v8_classification_loss``, ``OKS_SIGMA``,
``_crop_mask_loss``, ``v8_segmentation_loss`` and ``v8_pose_loss`` in
``xlstm_yolo_tpu/utils/loss.py``.  Targets are per-image padded arrays:
gt_labels (B, M) ints, gt_bboxes (B, M, 4) xyxy in image units (OBB:
gt_rboxes (B, M, 5) xywhr), mask_gt (B, M) validity; segment adds gt_masks
(B, M, Hm, Wm) at the prototypes' grid, pose gt_kpts (B, M, K, 3) in image
pixels.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from xlstm_yolo_tpu_torch.nn.head import dfl_decode, pose_decode
from xlstm_yolo_tpu_torch.utils.metrics import OKS_SIGMA, bbox_iou, probiou
from xlstm_yolo_tpu_torch.utils.tal import (
    bbox2dist,
    dist2bbox,
    dist2rbox,
    make_anchors,
    task_aligned_assign,
)
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
                      dfl_gain: float = 1.5, return_aux: bool = False):
    """One v8 detection loss over per-level (B, h, w, no) raw maps.
    Returns (total, LossItems); total is scaled by the batch size.  With
    ``return_aux`` also a dict of the assignment, the anchor points (feature
    units) and strides, the target-score sum and the per-anchor weight, for
    the segment and pose losses built on this one."""
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
    total = (items.box + items.cls + items.dfl) * B
    if return_aux:
        return total, items, dict(assign=assign, anchor_points=anchor_points,
                                  stride_t=stride_t, tss=tss, weight=weight)
    return total, items


def e2e_detect_loss(preds: dict, gt_labels, gt_bboxes, mask_gt, strides, nc: int = 80, **kw):
    """one2many (top-10) + one2one (top-1) losses, summed."""
    l_m, it_m = v8_detection_loss(preds["one2many"], gt_labels, gt_bboxes, mask_gt, strides,
                                  nc=nc, tal_topk=10, **kw)
    l_o, it_o = v8_detection_loss(preds["one2one"], gt_labels, gt_bboxes, mask_gt, strides,
                                  nc=nc, tal_topk=1, **kw)
    return l_m + l_o, LossItems(*(a + b for a, b in zip(it_m, it_o)))


def v8_obb_loss(preds: dict, gt_labels, gt_rboxes, mask_gt, strides: Sequence[float],
                nc: int = 80, reg_max: int = 16, tal_topk: int = 10, box_gain: float = 7.5,
                cls_gain: float = 0.5, dfl_gain: float = 1.5):
    """Oriented boxes: BCE classification, a probiou box term and DFL on the
    axis-aligned envelope of the rotated target, over the rotated
    assignment.  ``preds`` is the OBB head's {"one2many": maps, "angle":
    (B, A, ne)}; the angle's first channel is the box's.  Gts under 2 px
    wide or high are dropped.  Returns (total, LossItems)."""
    feats = preds["one2many"]
    B = feats[0].shape[0]
    no = nc + reg_max * 4
    flat = torch.cat([f.reshape(B, -1, no) for f in feats], dim=1)
    pred_distri, pred_scores = flat[..., : reg_max * 4], flat[..., reg_max * 4:]
    acc = acc_dtype(flat.dtype)
    angle = preds["angle"].to(acc)[..., :1]
    anchor_points, stride_t = make_anchors([f.shape[1:3] for f in feats], strides, 0.5,
                                           device=flat.device)
    anchor_points, stride_t = anchor_points.to(acc), stride_t.to(acc)
    gt_rboxes = gt_rboxes.to(acc)
    mask_gt = mask_gt.bool() & (gt_rboxes[..., 2] >= 2) & (gt_rboxes[..., 3] >= 2)

    dist = dfl_decode(pred_distri, reg_max)
    rbox4 = dist2rbox(dist.to(acc), angle, anchor_points[None])  # (B, A, 4) feature units
    pred_rboxes = torch.cat([rbox4, angle], -1)
    assign = task_aligned_assign(
        torch.sigmoid(pred_scores.to(acc)).detach(),
        torch.cat([rbox4 * stride_t[None], angle], -1).detach(), anchor_points * stride_t,
        gt_labels, gt_rboxes, mask_gt, topk=tal_topk, num_classes=nc, rotated=True)
    target_scores = assign.target_scores
    tb = assign.target_bboxes  # (B, A, 5) image units
    target_rboxes = torch.cat([tb[..., :4] / stride_t[None], tb[..., 4:]], -1)
    fg = assign.fg_mask
    tss = target_scores.sum().clamp(min=1.0)

    loss_cls = _bce_logits(pred_scores.to(acc), target_scores).sum() / tss
    weight = target_scores.sum(-1) * fg
    iou = probiou(pred_rboxes, target_rboxes)
    iou = torch.where(fg, iou, torch.ones_like(iou))
    loss_box = ((1.0 - iou) * weight).sum() / tss
    cxy, wh = target_rboxes[..., :2], target_rboxes[..., 2:4]
    target_ltrb = bbox2dist(anchor_points[None], torch.cat([cxy - wh / 2, cxy + wh / 2], -1),
                            reg_max - 1)
    dfl = _dfl_loss(pred_distri.reshape(B, -1, 4, reg_max), target_ltrb, reg_max)
    loss_dfl = (torch.where(fg, dfl, torch.zeros_like(dfl)) * weight).sum() / tss

    items = LossItems(loss_box * box_gain, loss_cls * cls_gain, loss_dfl * dfl_gain)
    return (items.box + items.cls + items.dfl) * B, items


def v8_classification_loss(logits, labels):
    """Mean softmax cross-entropy: (loss, loss)."""
    logp = F.log_softmax(logits.to(acc_dtype(logits.dtype)), dim=-1)
    loss = -logp.gather(-1, labels.long()[:, None])[:, 0].mean()
    return loss, loss


def _crop_mask_loss(loss_map, xyxy):
    """Zero the per-pixel loss (..., Hm, Wm) outside the mask-space box
    (..., 4)."""
    Hm, Wm = loss_map.shape[-2:]
    r = torch.arange(Wm, dtype=xyxy.dtype, device=xyxy.device)[None, :]
    c = torch.arange(Hm, dtype=xyxy.dtype, device=xyxy.device)[:, None]
    x1, y1, x2, y2 = (xyxy[..., i][..., None, None] for i in range(4))
    return loss_map * ((r >= x1) & (r < x2) & (c >= y1) & (c < y2))


def top_k_stable(x, k: int):
    """(values, indices) of the ``k`` largest entries of the last axis, ties
    to the lower index first (``lax.top_k``'s order; ``torch.topk``
    promises none)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def v8_segmentation_loss(preds: dict, gt_labels, gt_bboxes, mask_gt, gt_masks,
                         strides: Sequence[float], img_size: int, nc: int = 80, seg_k: int = 256,
                         **kw):
    """The detection loss plus a mask BCE over the ``seg_k`` foreground
    anchors of largest assigned score mass an image (ties to the lower
    anchor), each anchor's mask ``mask_coeffs @ proto`` against its gt's
    mask (B, M, Hm, Wm), cropped to its gt box in mask space and divided by
    that box's normalised area.  ``preds``: the Segment head's {"one2many",
    "mask_coeffs" (B, A, nm), "proto" (B, Hm, Wm, nm)}.  Returns (total,
    LossItems, the mask term times the box gain)."""
    acc = acc_dtype(preds["proto"].dtype)
    mc = preds["mask_coeffs"].to(acc)
    proto = preds["proto"].to(acc)
    B, Hm, Wm, _ = proto.shape
    total, items, aux = v8_detection_loss(preds["one2many"], gt_labels, gt_bboxes, mask_gt,
                                          strides, nc=nc, return_aux=True, **kw)
    assign = aux["assign"]
    fg = assign.fg_mask.to(acc)
    K = min(seg_k, fg.shape[1])
    topv, topi = top_k_stable(fg * (assign.target_scores.sum(-1) + 1e-6), K)
    valid = topv > 0
    mc_k = mc.gather(1, topi[..., None].expand(B, K, mc.shape[-1]))
    gt_idx = assign.target_gt_idx.gather(1, topi)
    tb = assign.target_bboxes.gather(1, topi[..., None].expand(B, K, 4))
    gmask = gt_masks.to(acc)[torch.arange(B, device=gt_idx.device)[:, None], gt_idx]
    mxyxy = tb * (torch.tensor([Wm, Hm, Wm, Hm], dtype=acc, device=tb.device) / img_size)
    area = ((mxyxy[..., 2] - mxyxy[..., 0]) * (mxyxy[..., 3] - mxyxy[..., 1])).clamp(
        min=1.0) / (Hm * Wm)
    pred_mask = torch.einsum("bkn,bhwn->bkhw", mc_k, proto)
    per_anchor = _crop_mask_loss(_bce_logits(pred_mask, gmask), mxyxy).mean((-2, -1)) / area
    loss_seg = (per_anchor * valid).sum() / fg.sum().clamp(min=1.0)
    box_gain = kw.get("box_gain", 7.5)
    return total + loss_seg * box_gain * B, items, loss_seg * box_gain


def v8_pose_loss(preds: dict, gt_labels, gt_bboxes, mask_gt, gt_kpts, strides: Sequence[float],
                 nc: int = 80, kpt_shape=(17, 3), pose_gain: float = 12.0,
                 kobj_gain: float = 1.0, **kw):
    """The detection loss plus the OKS-weighted keypoint location loss and,
    when the keypoints carry a visibility (nd == 3), its BCE, over the
    foreground anchors.  The sigmas are COCO's for K = 17, else 1/K.
    ``preds``: the Pose head's {"one2many", "kpts" (B, A, K * nd)}; gt_kpts
    (B, M, K, 3) image pixels (x, y, visibility).  Returns (total,
    LossItems, (the location term, the visibility term), each times its
    gain)."""
    feats, kpts = preds["one2many"], preds["kpts"]
    Knum, nd = kpt_shape
    total, items, aux = v8_detection_loss(feats, gt_labels, gt_bboxes, mask_gt, strides, nc=nc,
                                          return_aux=True, **kw)
    assign = aux["assign"]
    acc = aux["stride_t"].dtype
    fg = assign.fg_mask.to(acc)
    B = feats[0].shape[0]
    pred_kpts = pose_decode(kpts, aux["anchor_points"], aux["stride_t"], kpt_shape)
    gt_k = gt_kpts.to(acc)[torch.arange(B, device=fg.device)[:, None], assign.target_gt_idx]
    kpt_mask = (gt_k[..., 2] > 0).to(acc)  # (B, A, K)
    tb = assign.target_bboxes
    area = ((tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1])).clamp(min=1.0)
    sigmas = (torch.from_numpy(OKS_SIGMA).to(device=fg.device, dtype=acc) if Knum == 17
              else torch.full((Knum,), 1.0 / Knum, dtype=acc, device=fg.device))
    d = (pred_kpts[..., 0] - gt_k[..., 0]) ** 2 + (pred_kpts[..., 1] - gt_k[..., 1]) ** 2
    e = d / ((2 * sigmas) ** 2 * (area[..., None] + 1e-9) * 2)
    factor = Knum / kpt_mask.sum(-1).clamp(min=1e-9)
    loc = (factor[..., None] * (1.0 - torch.exp(-e)) * kpt_mask).mean(-1)
    fg_sum = fg.sum().clamp(min=1.0)
    loss_kpt = (loc * fg).sum() / fg_sum
    if nd == 3:
        vis = kpts.reshape(*kpts.shape[:2], Knum, nd)[..., 2].to(acc)
        loss_kobj = (_bce_logits(vis, kpt_mask).mean(-1) * fg).sum() / fg_sum
    else:
        loss_kobj = torch.zeros((), dtype=acc, device=fg.device)
    terms = (loss_kpt * pose_gain, loss_kobj * kobj_gain)
    return total + (terms[0] + terms[1]) * B, items, terms
