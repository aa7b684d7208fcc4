"""Prediction containers: Boxes / Results (the parts predict fills).

Counterpart of ``xlstm_yolo_tpu/engine/results.py``; host-side numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class Boxes:
    """(N, 6) array view: xyxy, conf, cls."""

    def __init__(self, data: np.ndarray, orig_shape: tuple[int, int]):
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[None]
        if data.shape[-1] != 6:
            raise ValueError(f"expected 6 columns, got {data.shape}")
        self.data = data
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return Boxes(self.data[idx], self.orig_shape)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, 4]

    @property
    def cls(self):
        return self.data[:, 5]


@dataclass
class Results:
    """One image's predictions."""

    orig_img: np.ndarray
    path: str
    names: dict
    boxes: Boxes | None = None
    speed: dict = field(default_factory=dict)

    def __len__(self):
        return len(self.boxes) if self.boxes is not None else 0

    def __getitem__(self, idx):
        return Results(self.orig_img, self.path, self.names, self.boxes[idx], self.speed)

    def update(self, boxes: np.ndarray | None = None):
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_img.shape[:2])
        return self
