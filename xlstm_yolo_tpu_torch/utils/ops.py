"""Box ops, letterbox inverse, NMS and a timer.

Counterpart of ``xlstm_yolo_tpu/utils/ops.py:26-345`` (the box and NMS
parts; the mask and rotated functions wait for ROADMAP item 10).  The
converters and the letterbox inverses take torch tensors or numpy arrays,
as JAX's take jnp or numpy.  :func:`nms` is JAX's fixed-shape greedy
``nms_jax`` (max_out steps of: keep the best live box, ties to the lowest
index as ``argmax``; kill it and every box whose IoU with it exceeds the
threshold), batched; :func:`non_max_suppression` wraps it with the
end2end bypass, on torch tensors.
"""

from __future__ import annotations

import time
from contextlib import ContextDecorator

import numpy as np
import torch


def _is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def _cat(parts, like):
    return torch.cat(parts, dim=-1) if _is_torch(like) else np.concatenate(parts, axis=-1)


def _stack(parts, like):
    return torch.stack(parts, dim=-1) if _is_torch(like) else np.stack(parts, axis=-1)


def _clip(x, lo, hi):
    return x.clamp(lo, hi) if _is_torch(x) else np.clip(x, lo, hi)


def _const(values, like):
    if _is_torch(like):
        return torch.tensor(values, dtype=like.dtype, device=like.device)
    return np.asarray(values, dtype=like.dtype)


def xywh2xyxy(x):
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh / 2
    return _cat([xy - half, xy + half, x[..., 4:]], x)


def xyxy2xywh(x):
    x1y1, x2y2 = x[..., :2], x[..., 2:4]
    return _cat([(x1y1 + x2y2) / 2, x2y2 - x1y1, x[..., 4:]], x)


def xywhn2xyxy(x, w, h, padw=0, padh=0):
    cx, cy, bw, bh = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return _stack([w * (cx - bw / 2) + padw, h * (cy - bh / 2) + padh,
                   w * (cx + bw / 2) + padw, h * (cy + bh / 2) + padh], x)


def xyxy2xywhn(x, w, h, clip=False, eps=0.0):
    if clip:
        x = clip_boxes(x, (h - eps, w - eps))
    y = xyxy2xywh(x)
    return y / _const([w, h, w, h], y)


def clip_boxes(boxes, shape):
    """Clip xyxy boxes to an image of shape (h, w, ...)."""
    h, w = shape[:2]
    return _stack([_clip(boxes[..., 0], 0, w), _clip(boxes[..., 1], 0, h),
                   _clip(boxes[..., 2], 0, w), _clip(boxes[..., 3], 0, h)], boxes)


def _gain_pad(img1_shape, img0_shape, ratio_pad):
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = (round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1),
               round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1))
        return gain, pad
    return ratio_pad[0][0], ratio_pad[1]


def scale_boxes(img1_shape, boxes, img0_shape, ratio_pad=None, padding: bool = True):
    """Rescale xyxy boxes from the letterboxed img1 back to the original img0."""
    gain, pad = _gain_pad(img1_shape, img0_shape, ratio_pad)
    if padding:
        boxes = boxes - _const([pad[0], pad[1], pad[0], pad[1]], boxes)
    return clip_boxes(boxes / gain, img0_shape)


def scale_coords(img1_shape, coords, img0_shape, ratio_pad=None, padding: bool = True):
    """Rescale (..., 2+) points from the letterboxed img1 back to img0; the
    channels after x and y pass through."""
    gain, pad = _gain_pad(img1_shape, img0_shape, ratio_pad)
    x, y = coords[..., 0], coords[..., 1]
    if padding:
        x, y = x - pad[0], y - pad[1]
    x = _clip(x / gain, 0, img0_shape[1])
    y = _clip(y / gain, 0, img0_shape[0])
    return _cat([_stack([x, y], coords), coords[..., 2:]], coords)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float = 0.45,
        max_out: int = 300) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of (..., N, 4) xyxy boxes by (..., N) scores (-inf: not a
    candidate) -> (keep_idx (..., max_out) int32, -1 where empty; keep_ok
    (..., max_out) bool).  The loop stops early once no image has a live
    box; the slots after stay -1 / False, as JAX's remaining steps leave them."""
    lead = scores.shape[:-1]
    boxes, live = boxes.reshape(-1, *boxes.shape[-2:]), scores.reshape(-1, scores.shape[-1]).clone()
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    keep_idx = torch.full((live.shape[0], max_out), -1, dtype=torch.int32, device=live.device)
    keep_ok = torch.zeros((live.shape[0], max_out), dtype=torch.bool, device=live.device)
    ninf = torch.tensor(-torch.inf, dtype=live.dtype, device=live.device)
    for i in range(max_out):
        best, j = live.max(-1)  # first index of the maximum, as argmax
        ok = best > -torch.inf
        if not bool(ok.any()):
            break
        keep_idx[:, i] = torch.where(ok, j.to(torch.int32), -1)
        keep_ok[:, i] = ok
        pick = j[:, None]
        xx1 = torch.maximum(x1.gather(1, pick), x1)
        yy1 = torch.maximum(y1.gather(1, pick), y1)
        xx2 = torch.minimum(x2.gather(1, pick), x2)
        yy2 = torch.minimum(y2.gather(1, pick), y2)
        inter = (xx2 - xx1).clamp(min=0) * (yy2 - yy1).clamp(min=0)
        iou = inter / (areas.gather(1, pick) + areas - inter + 1e-7)
        sel = torch.arange(live.shape[1], device=live.device)[None] == pick
        live = torch.where(((iou > iou_thres) | sel) & ok[:, None], ninf, live)
    return keep_idx.reshape(*lead, max_out), keep_ok.reshape(*lead, max_out)


def non_max_suppression(preds: torch.Tensor, conf_thres: float = 0.25, iou_thres: float = 0.45,
                        max_det: int = 300, nc: int = 80, end2end: bool = False,
                        max_wh: float = 7680.0, return_idx: bool = False):
    """Batched NMS -> ((B, max_det, 6) [xyxy, conf, cls], (B, max_det) valid).

    ``preds``: (B, N, 6) for an end2end head (conf filter and truncate only),
    else the decoded (B, A, 4+nc) [xywh, class scores]: best class per
    anchor, class-offset boxes, :func:`nms`; an empty slot holds anchor 0's
    row and is not valid.  ``return_idx`` adds the kept anchors (B, max_det)."""
    if end2end:
        out = preds[:, :max_det]
        valid = out[..., 4] > conf_thres
        if return_idx:
            ar = torch.arange(out.shape[1], device=out.device).expand(preds.shape[0], -1)
            return out, valid, ar
        return out, valid
    boxes = xywh2xyxy(preds[..., :4])
    conf, cls = preds[..., 4:4 + nc].max(-1)
    cls = cls.to(boxes.dtype)
    masked = torch.where(conf > conf_thres, conf, torch.full_like(conf, -torch.inf))
    idx, ok = nms(boxes + (cls * max_wh)[..., None], masked, iou_thres, max_det)
    idx = idx.clamp(min=0).long()
    cat = torch.cat([boxes, conf[..., None], cls[..., None]], dim=-1)
    out = cat.gather(1, idx[..., None].expand(-1, -1, cat.shape[-1]))
    if return_idx:
        return out, ok, idx
    return out, ok


class Profile(ContextDecorator):
    """Wall-clock timer: ``t`` accumulates, ``dt`` is the last span."""

    def __init__(self, t: float = 0.0):
        self.t = t
        self.dt = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dt = time.perf_counter() - self.start
        self.t += self.dt
        return False

    def __str__(self):
        return f"{self.t:.6f}s"
