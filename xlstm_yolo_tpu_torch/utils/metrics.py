"""IoU of boxes (counterpart of ``bbox_iou`` in
``xlstm_yolo_tpu/utils/metrics.py``)."""

from __future__ import annotations

import math

import torch


def bbox_iou(box1, box2, xywh: bool = True, kind: str = "iou", eps: float = 1e-7):
    """Elementwise IoU / GIoU / DIoU / CIoU of broadcastable (..., 4) boxes.

    The CIoU aspect term's weight alpha is taken without gradient, as in
    the JAX package (and the CIoU paper's implementation).
    """
    if xywh:
        x1, y1, w1, h1 = box1.chunk(4, dim=-1)
        x2, y2, w2, h2 = box2.chunk(4, dim=-1)
        b1_x1, b1_x2, b1_y1, b1_y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
        b2_x1, b2_x2, b2_y1, b2_y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.chunk(4, dim=-1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.chunk(4, dim=-1)
        w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
        w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps

    inter = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0) * (
        torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if kind == "iou":
        return iou.squeeze(-1)
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if kind == "giou":
        c_area = cw * ch + eps
        return (iou - (c_area - union) / c_area).squeeze(-1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    if kind == "diou":
        return (iou - rho2 / c2).squeeze(-1)
    if kind != "ciou":
        raise ValueError(f"unknown IoU kind {kind!r}")
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return (iou - (rho2 / c2 + v * alpha)).squeeze(-1)
