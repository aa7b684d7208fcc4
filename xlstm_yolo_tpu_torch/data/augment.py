"""Letterbox on the device (counterpart of ``LetterBox`` in
``xlstm_yolo_tpu/data/augment.py``).

The geometry (new size, ratio, padding) is the JAX package's.  The resize
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

    def __call__(self, img: torch.Tensor):
        """uint8 (H, W, 3) tensor -> (letterboxed uint8 tensor, ratio, (left, top))."""
        new_unpad, ratio, (left, top, right, bottom) = self.geometry(tuple(img.shape[:2]))
        if (img.shape[1], img.shape[0]) != new_unpad:
            img = resize_linear_u8(img, *new_unpad)
        x = F.pad(img.permute(2, 0, 1)[None], (left, right, top, bottom), value=self.pad_value)
        return x[0].permute(1, 2, 0), ratio, (left, top)
