"""Box ops, letterbox inverse, masks, NMS (axis-aligned and rotated) and a
timer.

Counterpart of ``xlstm_yolo_tpu/utils/ops.py:26-345``.  The converters,
the letterbox inverses and the mask ops take torch tensors or numpy
arrays, as JAX's take jnp or numpy.  :func:`nms` is JAX's fixed-shape
greedy ``nms_jax`` (max_out steps of: keep the best live box, ties to the
lowest index as ``argmax``; kill it and every box whose IoU with it
exceeds the threshold), batched; :func:`non_max_suppression` wraps it with
the end2end bypass, on torch tensors.  :func:`nms_rotated` is the same
loop over probiou (``nms_rotated_jax``), and
:func:`non_max_suppression_rotated` wraps it as JAX's does: the best class
of each anchor, no class offset (boxes of different classes suppress each
other, unlike the reference).
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


def crop_mask(masks, boxes):
    """Zero (n, Hm, Wm) masks outside their (n, 4) xyxy boxes in mask pixels
    (pixel centres at integer coordinates, x1 <= x < x2)."""
    if not _is_torch(masks):
        return crop_mask(torch.from_numpy(masks), torch.from_numpy(np.asarray(boxes))).numpy()
    Hm, Wm = masks.shape[-2:]
    r = torch.arange(Wm, dtype=masks.dtype, device=masks.device)[None, None, :]
    c = torch.arange(Hm, dtype=masks.dtype, device=masks.device)[None, :, None]
    x1, y1, x2, y2 = (boxes[:, i, None, None] for i in range(4))
    return masks * ((r >= x1) & (r < x2) & (c >= y1) & (c < y2))


def process_mask(proto, coeffs, boxes, img_hw):
    """Binary instance masks (n, Hm, Wm) at prototype resolution: the
    (Hm, Wm, nm) prototypes times the (n, nm) coefficients (in the
    prototypes' type), cropped to the (n, 4) xyxy boxes (model-input pixels,
    scaled to the mask grid), logit > 0.  Torch tensors (on any device) or
    numpy arrays."""
    if not _is_torch(proto):
        return process_mask(torch.from_numpy(proto), torch.from_numpy(np.asarray(coeffs)),
                            torch.from_numpy(np.asarray(boxes)), img_hw).numpy()
    Hm, Wm, nm = proto.shape
    ih, iw = img_hw
    logits = (coeffs.to(proto.dtype) @ proto.reshape(-1, nm).T).reshape(-1, Hm, Wm)
    scale = torch.tensor([Wm / iw, Hm / ih, Wm / iw, Hm / ih], dtype=logits.dtype,
                         device=logits.device)
    return crop_mask(logits, boxes.to(logits.dtype) * scale) > 0.0


def _greedy(scores: torch.Tensor, iou_of, iou_thres: float, max_out: int):
    """JAX's fixed-shape greedy loop over (b, N) ``scores`` (-inf: not a
    candidate): max_out steps of keeping each row's best live entry (ties to
    the lowest index, as ``argmax``) and killing it and every entry whose
    ``iou_of(j)`` (b, N) with it exceeds the threshold.  Stops once no row
    has a live entry; the slots after stay -1 / False, as JAX's remaining
    steps leave them."""
    live = scores.clone()
    keep_idx = torch.full((live.shape[0], max_out), -1, dtype=torch.int32, device=live.device)
    keep_ok = torch.zeros((live.shape[0], max_out), dtype=torch.bool, device=live.device)
    ninf = torch.tensor(-torch.inf, dtype=live.dtype, device=live.device)
    ar = torch.arange(live.shape[1], device=live.device)[None]
    for i in range(max_out):
        best, j = live.max(-1)  # first index of the maximum, as argmax
        ok = best > -torch.inf
        if not bool(ok.any()):
            break
        keep_idx[:, i] = torch.where(ok, j.to(torch.int32), -1)
        keep_ok[:, i] = ok
        sel = ar == j[:, None]
        live = torch.where(((iou_of(j) > iou_thres) | sel) & ok[:, None], ninf, live)
    return keep_idx, keep_ok


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float = 0.45,
        max_out: int = 300) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of (..., N, 4) xyxy boxes by (..., N) scores (-inf: not a
    candidate) -> (keep_idx (..., max_out) int32, -1 where empty; keep_ok
    (..., max_out) bool): :func:`_greedy` over IoU."""
    lead = scores.shape[:-1]
    boxes = boxes.reshape(-1, *boxes.shape[-2:])
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)

    def iou_of(j):
        pick = j[:, None]
        xx1 = torch.maximum(x1.gather(1, pick), x1)
        yy1 = torch.maximum(y1.gather(1, pick), y1)
        xx2 = torch.minimum(x2.gather(1, pick), x2)
        yy2 = torch.minimum(y2.gather(1, pick), y2)
        inter = (xx2 - xx1).clamp(min=0) * (yy2 - yy1).clamp(min=0)
        return inter / (areas.gather(1, pick) + areas - inter + 1e-7)

    keep_idx, keep_ok = _greedy(scores.reshape(-1, scores.shape[-1]), iou_of, iou_thres, max_out)
    return keep_idx.reshape(*lead, max_out), keep_ok.reshape(*lead, max_out)


def nms_rotated(rboxes: torch.Tensor, scores: torch.Tensor, iou_thres: float = 0.45,
                max_out: int = 300) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of (..., N, 5) xywhr boxes by probiou, otherwise as
    :func:`nms` (JAX's ``nms_rotated_jax``)."""
    from xlstm_yolo_tpu_torch.utils.metrics import probiou

    lead = scores.shape[:-1]
    rboxes = rboxes.reshape(-1, *rboxes.shape[-2:])

    def iou_of(j):
        return probiou(rboxes.gather(1, j[:, None, None].expand(-1, 1, 5)), rboxes)

    keep_idx, keep_ok = _greedy(scores.reshape(-1, scores.shape[-1]), iou_of, iou_thres, max_out)
    return keep_idx.reshape(*lead, max_out), keep_ok.reshape(*lead, max_out)


def non_max_suppression_rotated(preds: torch.Tensor, conf_thres: float = 0.25,
                                iou_thres: float = 0.45, max_det: int = 300,
                                nc: int | None = None):
    """Batched rotated NMS of decoded (B, A, 4+nc+1) [xywh, class scores,
    angle] rows -> ((B, max_det, 7) [xywhr, conf, cls], (B, max_det) valid);
    an empty slot holds anchor 0's row."""
    nc = nc if nc is not None else preds.shape[-1] - 5
    conf, cls = preds[..., 4:4 + nc].max(-1)
    cls = cls.to(preds.dtype)
    rb = torch.cat([preds[..., :4], preds[..., 4 + nc:][..., :1]], dim=-1)
    masked = torch.where(conf > conf_thres, conf, torch.full_like(conf, -torch.inf))
    idx, ok = nms_rotated(rb, masked, iou_thres, max_det)
    cat = torch.cat([rb, conf[..., None], cls[..., None]], dim=-1)
    out = cat.gather(1, idx.clamp(min=0).long()[..., None].expand(-1, -1, cat.shape[-1]))
    return out, ok


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
