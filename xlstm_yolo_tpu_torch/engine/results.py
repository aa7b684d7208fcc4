"""Prediction containers: Boxes and Results (detect task), host-side numpy.

Counterpart of ``xlstm_yolo_tpu/engine/results.py:17-65, 207-365``: the
box views, indexing, ``save_txt``, ``summary``, ``to_json`` and
``verbose``, whose strings and files equal JAX's on the same detections.
``plot`` and ``save`` draw with OpenCV in JAX (rectangles and Hershey
text) and are not ported yet (ROADMAP item 6).  Masks, keypoints, probs
and oriented boxes wait for ROADMAP item 10.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

_NO_PLOT = "draws with OpenCV in JAX and is not ported yet (ROADMAP item 6: plotting)"


class Boxes:
    """(N, 6|7) array view: xyxy, (track_id), conf, cls."""

    def __init__(self, data: np.ndarray, orig_shape: tuple[int, int]):
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[None]
        if data.shape[-1] not in (6, 7):
            raise ValueError(f"expected 6 or 7 columns, got {data.shape}")
        self.data = data
        self.orig_shape = orig_shape
        self.is_track = data.shape[-1] == 7

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return Boxes(self.data[idx], self.orig_shape)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def id(self):
        return self.data[:, 4] if self.is_track else None

    @property
    def xywh(self):
        x = self.xyxy
        return np.concatenate([(x[:, :2] + x[:, 2:]) / 2, x[:, 2:] - x[:, :2]], 1)

    @property
    def xyxyn(self):
        h, w = self.orig_shape
        return self.xyxy / np.array([w, h, w, h])

    @property
    def xywhn(self):
        h, w = self.orig_shape
        return self.xywh / np.array([w, h, w, h])


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

    def cpu(self):
        return self

    def numpy(self):
        return self

    def plot(self, *args, **kwargs):
        raise NotImplementedError(f"Results.plot {_NO_PLOT}")

    def save(self, filename=None):
        raise NotImplementedError(f"Results.save {_NO_PLOT}")

    def save_txt(self, txt_file: str | Path, save_conf: bool = False):
        """YOLO-format label lines: 'cls cx cy w h [conf]' normalized."""
        lines = []
        if self.boxes is not None:
            h, w = self.orig_img.shape[:2]
            for row in self.boxes.data:
                xywh = np.array([
                    (row[0] + row[2]) / 2 / w, (row[1] + row[3]) / 2 / h,
                    (row[2] - row[0]) / w, (row[3] - row[1]) / h,
                ])
                vals = [int(row[-1]), *xywh]
                if save_conf:
                    vals.append(float(row[-2]))
                lines.append(" ".join(f"{v:.6g}" if not isinstance(v, int) else str(v)
                                      for v in vals))
        Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
        Path(txt_file).write_text("\n".join(lines))
        return txt_file

    def to_json(self, normalize: bool = False) -> str:
        return json.dumps(self.summary(normalize=normalize), indent=2)

    def summary(self, normalize: bool = False) -> list[dict]:
        out = []
        if self.boxes is None:
            return out
        h, w = self.orig_img.shape[:2]
        for row in self.boxes.data:
            x1, y1, x2, y2 = row[:4]
            if normalize:
                x1, x2 = x1 / w, x2 / w
                y1, y2 = y1 / h, y2 / h
            c = int(row[-1])
            out.append({
                "name": self.names.get(c, str(c)),
                "class": c,
                "confidence": round(float(row[-2]), 5),
                "box": {"x1": float(x1), "y1": float(y1), "x2": float(x2), "y2": float(y2)},
            })
        return out

    def verbose(self) -> str:
        if not len(self):
            return "(no detections), "
        counts = {}
        for c in self.boxes.cls.astype(int):
            counts[c] = counts.get(c, 0) + 1
        return ", ".join(f"{n} {self.names.get(c, c)}{'s' if n > 1 else ''}"
                         for c, n in counts.items()) + ", "
