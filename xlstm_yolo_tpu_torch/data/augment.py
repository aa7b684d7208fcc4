"""Letterbox on the device (counterpart of ``LetterBox`` in
``xlstm_yolo_tpu/data/augment.py``) and the val pre-resize.

The geometry (new size, ratio, padding) is the JAX package's, and so is
the way boxes move through it (``scale_labels``, ``offset_labels``:
JAX's ``_scale_labels`` / ``_offset_labels``, detect boxes only), on the
host: label geometry needs no pixels.  The resize
is OpenCV's ``cv2.resize(..., INTER_LINEAR)`` for 3-channel uint8 images,
computed in integer arithmetic with torch on the tensor's own device, so
the pixels equal OpenCV's exactly:

- source coordinate ``(d + 0.5) * (src / dst) - 0.5`` in float32, split
  into ``floor`` and a fraction; 11-bit fixed-point weights
  ``round((1 - f) * 2048)`` and ``round(f * 2048)`` (round half to even);
- horizontally, columns left of 0 or past the last one take the border
  pixel with weight 2048; vertically the weights are kept and the row
  indices are clamped (both taps may then read the same row);
- the horizontal pass is exact in int32; the vertical pass rounds as
  OpenCV's vectorised 3-channel path does:
  ``((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2 >> 2``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE (11 bits)


def _linear_taps(src: int, dst: int, device, clamp_weights: bool):
    """(index0, index1, weight0, weight1) per output coordinate, OpenCV's
    INTER_LINEAR fixed-point taps (int64)."""
    d = torch.arange(dst, dtype=torch.float64, device=device)
    f = ((d + 0.5) * (1.0 / (dst / src)) - 0.5).float()
    s = torch.floor(f)
    f = f - s
    s = s.long()
    if clamp_weights:
        f = torch.where((s < 0) | (s >= src - 1), torch.zeros_like(f), f)
        s = s.clamp(0, src - 1)
    w1 = torch.round(f * COEF_SCALE).long()
    w0 = torch.round((1.0 - f) * COEF_SCALE).long()
    return s.clamp(0, src - 1), (s + 1).clamp(0, src - 1), w0, w1


def resize_linear_u8(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """OpenCV ``INTER_LINEAR`` resize of a uint8 (H, W, 3) tensor."""
    h, w, c = img.shape
    if c != 3 or img.dtype != torch.uint8:
        raise ValueError(f"expected a uint8 (H, W, 3) image, got {img.dtype} {tuple(img.shape)}")
    x0, x1, a0, a1 = _linear_taps(w, width, img.device, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(h, height, img.device, clamp_weights=False)
    src = img.long()
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]  # (h, width, 3)
    r0, r1 = rows[y0] >> 4, rows[y1] >> 4
    out = ((r0 * b0[:, None, None]) >> 16) + ((r1 * b1[:, None, None]) >> 16)
    return ((out + 2) >> 2).clamp_(0, 255).to(torch.uint8)


def val_resized_shape(shape: tuple[int, int], imgsz: int) -> tuple[int, int]:
    """(h, w) an image of ``shape`` is resized to before the val letterbox:
    the long side to ``imgsz``, up or down, each side ``ceil(side * r)``
    capped at ``imgsz`` (JAX ``YOLODataset.get_sample``, the reference's
    ``load_image``); the shape itself when the long side is ``imgsz``."""
    h0, w0 = shape
    r = imgsz / max(h0, w0)
    if r == 1:
        return h0, w0
    return min(math.ceil(h0 * r), imgsz), min(math.ceil(w0 * r), imgsz)


def scale_labels(labels: dict, r: float) -> dict:
    return {**labels, "bboxes": labels["bboxes"] * r}


def offset_labels(labels: dict, dx: int, dy: int) -> dict:
    b = labels["bboxes"].copy()
    b[:, [0, 2]] += dx
    b[:, [1, 3]] += dy
    return {**labels, "bboxes": b}


@dataclass
class LetterBox:
    """Aspect-preserving resize + constant padding to ``new_shape``."""

    new_shape: tuple[int, int] = (640, 640)
    auto: bool = False
    scale_fill: bool = False
    scaleup: bool = True
    center: bool = True
    stride: int = 32
    pad_value: int = 114

    def geometry(self, shape: tuple[int, int]):
        """(resized (w, h), ratio (rw, rh), (left, top, right, bottom))."""
        new_shape = self.new_shape
        r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
        if not self.scaleup:
            r = min(r, 1.0)
        ratio = (r, r)
        new_unpad = (round(shape[1] * r), round(shape[0] * r))
        dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
        if self.auto:
            dw, dh = dw % self.stride, dh % self.stride
        elif self.scale_fill:
            dw, dh = 0, 0
            new_unpad = (new_shape[1], new_shape[0])
            ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])
        if self.center:
            dw /= 2
            dh /= 2
        top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
        left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
        return new_unpad, ratio, (left, top, right, bottom)

    def place_labels(self, labels: dict, shape: tuple[int, int]):
        """Move xyxy pixel ``labels`` of an image of ``shape`` (h, w) into the
        letterboxed frame: (labels, (ratio, (left, top)))."""
        _, ratio, (left, top, _, _) = self.geometry(shape)
        r = min(self.new_shape[0] / shape[0], self.new_shape[1] / shape[1])
        if not self.scaleup:
            r = min(r, 1.0)
        return offset_labels(scale_labels(labels, r), left, top), (ratio, (left, top))

    def __call__(self, img: torch.Tensor):
        """uint8 (H, W, 3) tensor -> (letterboxed uint8 tensor, ratio, (left, top))."""
        new_unpad, ratio, (left, top, right, bottom) = self.geometry(tuple(img.shape[:2]))
        if (img.shape[1], img.shape[0]) != new_unpad:
            img = resize_linear_u8(img, *new_unpad)
        x = F.pad(img.permute(2, 0, 1)[None], (left, right, top, bottom), value=self.pad_value)
        return x[0].permute(1, 2, 0), ratio, (left, top)
