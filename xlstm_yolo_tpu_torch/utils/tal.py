"""Anchor geometry (counterpart of ``make_anchors`` / ``dist2bbox`` in
``xlstm_yolo_tpu/utils/tal.py``)."""

from __future__ import annotations

from typing import Sequence

import torch

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
