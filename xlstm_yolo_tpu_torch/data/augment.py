"""Letterbox on the device (counterpart of ``LetterBox`` in
``xlstm_yolo_tpu/data/augment.py``).

The geometry (new size, ratio, padding) is the JAX package's; the resize
is a bilinear ``F.interpolate`` with half-pixel centres on the tensor's own
device instead of ``cv2.resize``, so pixels may differ from OpenCV's by
interpolation rounding.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


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
        """uint8 (H, W, C) tensor -> (letterboxed uint8 tensor, ratio, (left, top))."""
        new_unpad, ratio, (left, top, right, bottom) = self.geometry(tuple(img.shape[:2]))
        x = img.permute(2, 0, 1)[None]
        if (img.shape[1], img.shape[0]) != new_unpad:
            x = F.interpolate(x.float(), size=(new_unpad[1], new_unpad[0]), mode="bilinear",
                              align_corners=False)
            x = x.round_().clamp_(0, 255).to(img.dtype)
        x = F.pad(x, (left, right, top, bottom), value=self.pad_value)
        return x[0].permute(1, 2, 0), ratio, (left, top)
