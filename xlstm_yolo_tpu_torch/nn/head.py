"""Detect / v10Detect heads: DFL decode + NMS-free top-k, and the task heads
(Segment, OBB, Pose, Classify), NHWC.

Counterpart of ``xlstm_yolo_tpu/nn/head.py`` (``dfl_decode``,
``topk_postprocess``, ``Detect``, ``v10Detect``, ``Proto``, ``Segment``,
``OBB``, ``Pose``, ``Classify``, ``pose_decode``).  DFL is decoded
analytically (no frozen arange conv, so no extra state-dict entry).  At
inference the end2end head runs only its one2one branch: the one2many
branch feeds training alone (the JAX predict program drops it as dead
code).  In training the head returns the raw level maps,
``{"one2many": maps, "one2one": maps}`` for the end2end head (its one2one
towers see detached features, so their loss trains only them), or the
list of maps.

The task heads are one-to-many heads (no end2end branch; their detections
go through NMS).  In eval each returns JAX's pair: the decoded (B, A,
4+nc+extra) rows (``Segment``: the mask coefficients, ``OBB``: the angle,
``Pose``: the decoded keypoints) and the aux dict (``proto`` and
``mask_coeffs``, ``angle`` or ``kpts``); ``Classify`` returns (softmax,
logits).  The dtypes are JAX's: the angle is ``(sigmoid(raw) - 0.25) * pi``
in float32, ``Classify``'s linear layer runs on the pooled features cast
to float32, Proto's transposed conv runs in float32 (flax promotes its
bfloat16 input to the float32 kernel).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from xlstm_yolo_tpu_torch.nn.blocks import ConvBNAct
from xlstm_yolo_tpu_torch.nn.layers import Conv, ConvTranspose, Dense, const_init
from xlstm_yolo_tpu_torch.utils.tal import dist2bbox, dist2rbox, make_anchors
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


class Proto(nn.Module):
    """Mask prototypes: ConvBNAct -> 2x transposed-conv upsample -> ConvBNAct
    -> 1x1 ConvBNAct to ``nm`` maps."""

    def __init__(self, c1: int, npr: int = 256, nm: int = 32,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.cv1 = ConvBNAct(c1, npr, 3, compute_dtype=compute_dtype)
        self.upsample = ConvTranspose(npr, npr, 2)
        self.cv2 = ConvBNAct(npr, npr, 3, compute_dtype=compute_dtype)
        self.cv3 = ConvBNAct(npr, nm, 1, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


def _towers(ch, c4: int, c_out: int, cd, fused: bool) -> nn.ModuleList:
    """The per-level extra tower of a task head (JAX's ``cv4_{i}_{j}``)."""
    return nn.ModuleList(
        nn.Sequential(ConvBNAct(c, c4, 3, compute_dtype=cd, fused=fused),
                      ConvBNAct(c4, c4, 3, compute_dtype=cd, fused=fused),
                      Conv(c4, c_out, 1, compute_dtype=cd)) for c in ch)


def _per_anchor(towers, feats) -> torch.Tensor:
    """Each level's tower output flattened to (B, h*w, c), levels concatenated."""
    return torch.cat([t(x).flatten(1, 2) for t, x in zip(towers, feats)], dim=1)


class _TaskHead(Detect):
    """A one-to-many Detect whose eval output carries per-anchor extras."""

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), strides: Sequence[float] = (),
                 img_size: int = 640, compute_dtype: torch.dtype | None = None,
                 fused: bool = False):
        super().__init__(nc=nc, ch=ch, strides=strides, img_size=img_size,
                         compute_dtype=compute_dtype, fused=fused)

    def _maps(self, feats):
        return self._branches(feats, self.cv2, self.cv3)


class Segment(_TaskHead):
    """Detect + prototype net on the first level + a mask-coefficient tower
    per level; eval: ((B, A, 4+nc+nm), {"one2many", "mask_coeffs", "proto"})."""

    def __init__(self, nc: int = 80, nm: int = 32, npr: int = 256, ch: Sequence[int] = (),
                 compute_dtype: torch.dtype | None = None, fused: bool = False, **kw):
        super().__init__(nc=nc, ch=ch, compute_dtype=compute_dtype, fused=fused, **kw)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm, compute_dtype)
        self.cv4 = _towers(ch, max(ch[0] // 4, nm), nm, compute_dtype, fused)

    def forward(self, feats, img_hw: tuple[int, int]):
        proto = self.proto(feats[0])
        mc = _per_anchor(self.cv4, feats)
        maps = self._maps(feats)
        if self.training:
            return {"one2many": maps, "mask_coeffs": mc, "proto": proto}
        y = self._decode(maps, tuple(img_hw[0] / x.shape[1] for x in feats))
        return torch.cat([y, mc.to(y.dtype)], dim=-1), {
            "one2many": maps, "mask_coeffs": mc, "proto": proto}


class OBB(_TaskHead):
    """Detect + an angle tower per level; the angle is (sigmoid - 0.25) * pi
    in float32 and the boxes decode with ``dist2rbox``; eval: ((B, A,
    4+nc+ne) [xywh, class scores, angle], {"one2many", "angle"})."""

    def __init__(self, nc: int = 80, ne: int = 1, ch: Sequence[int] = (),
                 compute_dtype: torch.dtype | None = None, fused: bool = False, **kw):
        super().__init__(nc=nc, ch=ch, compute_dtype=compute_dtype, fused=fused, **kw)
        self.ne = ne
        self.cv4 = _towers(ch, max(ch[0] // 4, ne), ne, compute_dtype, fused)

    def _decode_rotated(self, level_maps, strides, angle):
        B = level_maps[0].shape[0]
        anchors, stride_t = make_anchors([m.shape[1:3] for m in level_maps], strides, 0.5,
                                         device=level_maps[0].device)
        flat = torch.cat([m.reshape(B, -1, self.no) for m in level_maps], dim=1)
        box, cls = flat[..., : 4 * self.reg_max], flat[..., 4 * self.reg_max:]
        acc = acc_dtype(flat.dtype)
        dist = dfl_decode(box, self.reg_max)
        rbox = dist2rbox(dist.to(acc), angle.to(acc), anchors[None]) * stride_t[None]
        return torch.cat([rbox.to(flat.dtype), torch.sigmoid(cls.to(acc)).to(flat.dtype)], -1)

    def forward(self, feats, img_hw: tuple[int, int]):
        raw = _per_anchor(self.cv4, feats)
        angle = (torch.sigmoid(raw.to(acc_dtype(raw.dtype))) - 0.25) * math.pi
        maps = self._maps(feats)
        if self.training:
            return {"one2many": maps, "angle": angle}
        y = self._decode_rotated(maps, tuple(img_hw[0] / x.shape[1] for x in feats), angle)
        return torch.cat([y, angle.to(y.dtype)], dim=-1), {"one2many": maps, "angle": angle}


def pose_decode(kpts, anchors, stride_t, kpt_shape):
    """(B, A, K*nd) raw -> (B, A, K, nd) image-space keypoints: xy = (raw * 2
    + anchor - 0.5) * stride, the visibility through a sigmoid."""
    B, A, _ = kpts.shape
    K, nd = kpt_shape
    k = kpts.reshape(B, A, K, nd).to(acc_dtype(kpts.dtype))
    xy = (k[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * stride_t[None, :, None, :]
    if nd == 3:
        return torch.cat([xy, torch.sigmoid(k[..., 2:3])], dim=-1)
    return xy


class Pose(_TaskHead):
    """Detect + a keypoint tower per level; eval: ((B, A, 4+nc+K*nd) with the
    decoded keypoints, {"one2many", "kpts"} with the raw ones)."""

    def __init__(self, nc: int = 80, kpt_shape: Sequence[int] = (17, 3),
                 ch: Sequence[int] = (), compute_dtype: torch.dtype | None = None,
                 fused: bool = False, **kw):
        super().__init__(nc=nc, ch=ch, compute_dtype=compute_dtype, fused=fused, **kw)
        self.kpt_shape = tuple(kpt_shape)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        self.cv4 = _towers(ch, max(ch[0] // 4, nk), nk, compute_dtype, fused)

    def forward(self, feats, img_hw: tuple[int, int]):
        kpts = _per_anchor(self.cv4, feats)
        maps = self._maps(feats)
        if self.training:
            return {"one2many": maps, "kpts": kpts}
        strides = tuple(img_hw[0] / x.shape[1] for x in feats)
        y = self._decode(maps, strides)
        anchors, stride_t = make_anchors([x.shape[1:3] for x in feats], strides, 0.5,
                                         device=feats[0].device)
        dec = pose_decode(kpts, anchors, stride_t, self.kpt_shape)
        B, A = dec.shape[:2]
        return torch.cat([y, dec.reshape(B, A, -1).to(y.dtype)], dim=-1), {
            "one2many": maps, "kpts": kpts}


class Classify(nn.Module):
    """ConvBNAct to 1280 channels -> global average pool -> linear on float32;
    eval: (softmax, logits), train: logits.  Dropout is JAX's default, 0."""

    def __init__(self, c1: int, c2: int = 1000, k: int = 1, s: int = 1,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        c_ = 1280  # efficientnet_b0's width, as in the reference
        self.conv = ConvBNAct(c1, c_, k, s, compute_dtype=compute_dtype)
        self.linear = Dense(c_, c2)

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            x = torch.cat(list(x), dim=-1)
        y = self.conv(x).mean(dim=(1, 2))
        logits = self.linear(y.to(acc_dtype(y.dtype)))
        if self.training:
            return logits
        return torch.softmax(logits, dim=-1), logits
