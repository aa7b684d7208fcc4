"""Detect / v10Detect heads: DFL decode + NMS-free top-k, NHWC.

Counterpart of ``xlstm_yolo_tpu/nn/head.py`` (``dfl_decode``,
``topk_postprocess``, ``Detect``, ``v10Detect``).  DFL is decoded
analytically (no frozen arange conv, so no extra state-dict entry).  At
inference the end2end head runs only its one2one branch: the one2many
branch feeds training alone (the JAX predict program drops it as dead
code).  In training the head returns the raw level maps,
``{"one2many": maps, "one2one": maps}`` for the end2end head (its one2one
towers see detached features, so their loss trains only them), or the
list of maps.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from xlstm_yolo_tpu_torch.nn.blocks import ConvBNAct
from xlstm_yolo_tpu_torch.nn.layers import Conv, const_init
from xlstm_yolo_tpu_torch.utils.tal import dist2bbox, make_anchors
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype


def dfl_decode(dist: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Softmax over bins -> expectation.  (B, A, 4*reg_max) -> (B, A, 4)."""
    B, A, _ = dist.shape
    acc = acc_dtype(dist.dtype)
    p = torch.softmax(dist.reshape(B, A, 4, reg_max).to(acc), dim=-1)
    bins = torch.arange(reg_max, dtype=acc, device=dist.device)
    return (p * bins).sum(-1).to(dist.dtype)


def topk_postprocess(preds: torch.Tensor, max_det: int, nc: int = 80) -> torch.Tensor:
    """(B, A, 4+nc) -> (B, max_det, 6) [xyxy, score, cls] via two top-ks."""
    B, A, _ = preds.shape
    boxes, scores = preds[..., :4], preds[..., 4:]
    k = min(max_det, A)
    _, idx = scores.amax(-1).topk(k, dim=1)
    boxes = boxes.gather(1, idx[..., None].expand(B, k, 4))
    scores = scores.gather(1, idx[..., None].expand(B, k, nc))
    flat_scores, flat_idx = scores.reshape(B, -1).topk(k, dim=1)
    anchor_idx = flat_idx // nc
    cls_idx = flat_idx % nc
    boxes = boxes.gather(1, anchor_idx[..., None].expand(B, k, 4))
    return torch.cat([boxes, flat_scores[..., None], cls_idx[..., None].to(boxes.dtype)], -1)


class Detect(nn.Module):
    """YOLO detect head (DFL box tower + light depthwise cls tower), NHWC.

    ``strides`` are the nominal level strides, used for the cls bias init;
    the decode takes its strides from the input size.  ``end2end`` adds the
    one2one towers (the v10 head).  ``fused``: the towers' ConvBNActs carry
    their folded BatchNorms (eval only).
    """

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), strides: Sequence[float] = (),
                 reg_max: int = 16, end2end: bool = False, max_det: int = 300,
                 img_size: int = 640, decode_only: bool = False,
                 compute_dtype: torch.dtype | None = None, fused: bool = False):
        super().__init__()
        self.nc, self.reg_max, self.end2end = nc, reg_max, end2end
        self.max_det, self.decode_only = max_det, decode_only
        self.no = nc + 4 * reg_max
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        cd = compute_dtype

        def box_tower(cin):
            return nn.Sequential(ConvBNAct(cin, c2, 3, compute_dtype=cd, fused=fused),
                                 ConvBNAct(c2, c2, 3, compute_dtype=cd, fused=fused),
                                 Conv(c2, 4 * reg_max, 1, bias_init=const_init(1.0),
                                      compute_dtype=cd))

        def cls_tower(cin, s):
            bias = math.log(5 / nc / (img_size / s) ** 2)
            return nn.Sequential(
                nn.Sequential(ConvBNAct(cin, cin, 3, g=cin, compute_dtype=cd, fused=fused),
                              ConvBNAct(cin, c3, 1, compute_dtype=cd, fused=fused)),
                nn.Sequential(ConvBNAct(c3, c3, 3, g=c3, compute_dtype=cd, fused=fused),
                              ConvBNAct(c3, c3, 1, compute_dtype=cd, fused=fused)),
                Conv(c3, nc, 1, bias_init=const_init(bias), compute_dtype=cd))

        self.cv2 = nn.ModuleList(box_tower(c) for c in ch)
        self.cv3 = nn.ModuleList(cls_tower(c, s) for c, s in zip(ch, strides))
        if end2end:
            self.one2one_cv2 = nn.ModuleList(box_tower(c) for c in ch)
            self.one2one_cv3 = nn.ModuleList(cls_tower(c, s) for c, s in zip(ch, strides))

    @staticmethod
    def _branches(feats, cv2, cv3):
        return [torch.cat([b(x), c(x)], dim=-1) for x, b, c in zip(feats, cv2, cv3)]

    def _decode(self, level_maps, strides):
        """Per-level (B, h, w, no) -> (B, A, 4+nc) with DFL + dist2bbox."""
        B = level_maps[0].shape[0]
        anchors, stride_t = make_anchors([m.shape[1:3] for m in level_maps], strides, 0.5,
                                         device=level_maps[0].device)
        flat = torch.cat([m.reshape(B, -1, self.no) for m in level_maps], dim=1)
        box, cls = flat[..., : 4 * self.reg_max], flat[..., 4 * self.reg_max:]
        dist = dfl_decode(box, self.reg_max)
        dbox = dist2bbox(dist, anchors[None], xywh=not self.end2end) * stride_t[None]
        return torch.cat([dbox, torch.sigmoid(cls.to(acc_dtype(cls.dtype))).to(dbox.dtype)], dim=-1)

    def forward(self, feats, img_hw: tuple[int, int]):
        if self.training:
            one2many = self._branches(feats, self.cv2, self.cv3)
            if not self.end2end:
                return one2many
            one2one = self._branches([x.detach() for x in feats], self.one2one_cv2,
                                     self.one2one_cv3)
            return {"one2many": one2many, "one2one": one2one}
        strides = tuple(img_hw[0] / x.shape[1] for x in feats)
        if self.end2end:
            maps = self._branches(feats, self.one2one_cv2, self.one2one_cv3)
            aux = {"one2one": maps}
        else:
            maps = self._branches(feats, self.cv2, self.cv3)
            aux = {"one2many": maps}
        y = self._decode(maps, strides)
        if self.end2end and not self.decode_only:
            y = topk_postprocess(y, self.max_det, self.nc)
        return y, aux


class v10Detect(Detect):
    """End2end detect head of the shipped configs."""

    def __init__(self, *args, **kw):
        kw.setdefault("end2end", True)
        super().__init__(*args, **kw)
