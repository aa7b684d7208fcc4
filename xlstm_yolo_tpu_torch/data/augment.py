"""Letterbox on the device (counterpart of ``LetterBox`` in
``xlstm_yolo_tpu/data/augment.py``), the val pre-resize, and the label
side of the train transforms.

The geometry (new size, ratio, padding) is the JAX package's, and so is
the way labels move through it (``scale_labels``, ``offset_labels``:
JAX's ``_scale_labels`` / ``_offset_labels``: boxes, and the segments and
keypoints of the task datasets where a sample has them), on the host:
label geometry needs no pixels.  ``resample_segments`` is JAX's: each
closed polygon sampled at ``SEGMENT_RESAMPLE`` evenly spaced points.  The resize
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

The train transforms (``Mosaic`` 4 and 9, ``RandomPerspective``,
``RandomHSV``, ``RandomFlip``, ``CopyPaste``, mixup and
``TrainTransforms``) are JAX's, on the host in numpy, for every task's
labels: ``cls``, xyxy pixel ``bboxes``, the (n, SEGMENT_RESAMPLE, 2)
pixel ``segments`` of segment and OBB datasets ((n, 0, 2) otherwise) and
the (n, K, 3) pixel ``keypoints`` of pose datasets (None otherwise).  The
warp moves the polygons point by point and takes the boxes from them
(``segments_to_boxes``; its candidate filter then keeps 1% of the area,
not 10%), and moves the keypoints, those off the canvas made invisible
(as ``clip_labels`` does); the flips mirror them, a horizontal flip
swapping the keypoints by ``flip_idx``; copy-paste mirrors the polygon and
pastes nothing for keypoint datasets.  They draw from the sample's
``random.Random`` exactly as JAX's do, draw for draw, and move the labels
with JAX's arithmetic; where
JAX calls OpenCV on pixels they record what to do instead: a per-sample
*recipe* that ``pixels.compose_batch`` carries out on the device, with
the decoded images (*tiles*) it refers to.  A recipe is a dict:

- ``canvas``: ``{"size": (h, w), "tiles": [(tile, [(w, h) resizes],
  dst (y1, y2, x1, x2), src (y1, y2, x1, x2))], "crop": (y, x, h, w) or
  None}`` on a 114-filled canvas;
- ``warp``: ``{"M": 3x3 float64 or None (no warp), "dsize": (w, h),
  "perspective": bool}``;
- ``mixup``: None or ``{"canvas", "warp", "r"}``;
- ``paste``: copy-paste rectangles ``(y1, y2, x1, x2, nx1, nx2)``;
- ``hsv``: None or the (3, 256) uint8 LUTs; ``flipud``, ``fliplr``.

``ClassifyAugment`` (classify's train transform: a random resized crop
drawn as torchvision's, with Python's ``round``, the flips, HSV and random
erasing with value 0) is a recipe too: ``{"crop": (top, left, h, w),
"size", "fliplr", "flipud", "hsv", "erase": (top, left, h, w) or None}``
(``pixels.compose_classify``).

Mixup's ratio is JAX's ``np.random.beta(32, 32)`` from numpy's global
state, which nothing can hold against JAX; :func:`mixup_ratio` draws it
from a generator seeded with the sample's rng state, without advancing
that rng, so a run repeats.  ``Albumentations`` is absent on both
machines and, as in JAX, draws nothing then; its transforms are not
ported (the transforms say so when the package is installed).
"""

from __future__ import annotations

import importlib.util
import math
import random
from dataclasses import dataclass
from typing import Any

import numpy as np
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


SEGMENT_RESAMPLE = 400  # points of each instance's polygon


def resample_segments(segments, n: int = SEGMENT_RESAMPLE) -> np.ndarray:
    """A list of (P, 2) polygons -> (N, n, 2) float32: each closed polygon
    sampled at ``n`` evenly spaced points by linear interpolation."""
    out = np.zeros((len(segments), n, 2), np.float32)
    for i, s in enumerate(segments):
        s = np.concatenate([s, s[0:1]], axis=0)
        x = np.linspace(0, len(s) - 1, n)
        xp = np.arange(len(s))
        out[i] = np.stack([np.interp(x, xp, s[:, 0]), np.interp(x, xp, s[:, 1])], axis=-1)
    return out


def scale_labels(labels: dict, r: float) -> dict:
    out = {**labels, "bboxes": labels["bboxes"] * r, "segments": labels["segments"] * r}
    if labels.get("keypoints") is not None:
        k = labels["keypoints"].copy()
        k[..., :2] *= r
        out["keypoints"] = k
    return out


def offset_labels(labels: dict, dx: int, dy: int) -> dict:
    b = labels["bboxes"].copy()
    b[:, [0, 2]] += dx
    b[:, [1, 3]] += dy
    out = {**labels, "bboxes": b}
    s = labels["segments"].copy()
    if s.size:
        s[..., 0] += dx
        s[..., 1] += dy
    out["segments"] = s
    if labels.get("keypoints") is not None:
        k = labels["keypoints"].copy()
        k[..., 0] += dx
        k[..., 1] += dy
        out["keypoints"] = k
    return out


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


# ---------------------------------------------------------------------------
# the train transforms: labels on the host, pixels as recipes


def _index_labels(labels: dict, keep) -> dict:
    k = labels.get("keypoints")
    return {**labels, "cls": labels["cls"][keep], "bboxes": labels["bboxes"][keep],
            "segments": labels["segments"][keep], "keypoints": None if k is None else k[keep]}


def _cat_labels(parts: list[dict]) -> dict:
    out = {k: np.concatenate([p[k] for p in parts], 0) for k in ("cls", "bboxes", "segments")}
    out["keypoints"] = (np.concatenate([p["keypoints"] for p in parts], 0)
                        if parts[0].get("keypoints") is not None else None)
    return out


def _invisible_outside(k: np.ndarray, w: float, h: float) -> np.ndarray:
    """Keypoints (..., 3) with the visibility of those outside [0, w] x [0, h]
    set to 0 (their coordinates kept)."""
    outside = (k[..., 0] < 0) | (k[..., 0] > w) | (k[..., 1] < 0) | (k[..., 1] > h)
    k[..., 2] = np.where(outside, 0.0, k[..., 2])
    return k


def clip_labels(labels: dict, w: float, h: float) -> dict:
    """Boxes and segments clipped to the canvas; keypoints outside it made
    invisible."""
    b = labels["bboxes"].copy()
    b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
    b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
    s = labels["segments"].copy()
    if s.size:
        s[..., 0] = s[..., 0].clip(0, w)
        s[..., 1] = s[..., 1].clip(0, h)
    k = labels.get("keypoints")
    return {**labels, "bboxes": b, "segments": s,
            "keypoints": None if k is None else _invisible_outside(k.copy(), w, h)}


def segments_to_boxes(segments: np.ndarray, w: float, h: float) -> np.ndarray:
    """(N, P, 2) pixel polygons -> (N, 4) xyxy boxes of their points clipped
    to the canvas."""
    if not len(segments):
        return np.zeros((0, 4), np.float32)
    x = segments[..., 0].clip(0, w)
    y = segments[..., 1].clip(0, h)
    return np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1).astype(np.float32)


def _box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
    """Keep the post-warp boxes that are not degenerate."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def rotation_matrix(angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(angle=angle, center=(0, 0), scale=scale)``."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, 0.0], [-beta, alpha, 0.0]])


def mixup_ratio(rng: random.Random) -> float:
    """Mixup's r ~ Beta(32, 32), from a generator seeded with ``rng``'s state
    (``rng`` does not advance)."""
    return float(np.random.default_rng(rng.getstate()[1]).beta(32.0, 32.0))


def _tile(tiles: list, im: np.ndarray, w: int, h: int, dst: tuple, src: tuple,
          sizes: list | None = None) -> tuple:
    """Add decoded image ``im`` to the sample's ``tiles`` and return its
    canvas entry: resized to (w, h) (and on through ``sizes``), its ``src``
    rows and columns pasted at ``dst``."""
    tiles.append(im)
    resize = [] if im.shape[:2] == (h, w) else [(int(w), int(h))]
    return (len(tiles) - 1, resize + (sizes or []), tuple(int(v) for v in dst),
            tuple(int(v) for v in src))


def hsv_luts(r: np.ndarray) -> np.ndarray:
    """``RandomHSV``'s hue, saturation and value LUTs for gains ``r`` (3,)
    float64: (3, 256) uint8 (hue ``% 180`` and s, v clipped, all truncated)."""
    x = np.arange(0, 256, dtype=r.dtype)
    lut_h = ((x * r[0]) % 180).astype(np.uint8)
    lut_s = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_v = np.clip(x * r[2], 0, 255).astype(np.uint8)
    return np.stack([lut_h, lut_s, lut_v])


@dataclass
class RandomPerspective:
    """Affine (or perspective) warp of the image and its boxes."""

    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0
    border: tuple[int, int] = (0, 0)

    def _matrix(self, shape: tuple[int, int], rng: random.Random):
        C = np.eye(3)
        C[0, 2] = -shape[1] / 2
        C[1, 2] = -shape[0] / 2
        P = np.eye(3)
        P[2, 0] = rng.uniform(-self.perspective, self.perspective)
        P[2, 1] = rng.uniform(-self.perspective, self.perspective)
        R = np.eye(3)
        a = rng.uniform(-self.degrees, self.degrees)
        s = rng.uniform(1 - self.scale, 1 + self.scale)
        R[:2] = rotation_matrix(a, s)
        S = np.eye(3)
        S[0, 1] = math.tan(rng.uniform(-self.shear, self.shear) * math.pi / 180)
        S[1, 0] = math.tan(rng.uniform(-self.shear, self.shear) * math.pi / 180)
        T = np.eye(3)
        h = shape[0] + self.border[0] * 2
        w = shape[1] + self.border[1] * 2
        T[0, 2] = rng.uniform(0.5 - self.translate, 0.5 + self.translate) * w
        T[1, 2] = rng.uniform(0.5 - self.translate, 0.5 + self.translate) * h
        return T @ S @ R @ P @ C, s, w, h

    def _apply_points(self, pts: np.ndarray, M: np.ndarray) -> np.ndarray:
        shp = pts.shape
        xy = np.ones((int(np.prod(shp[:-1])), 3))
        xy[:, :2] = pts.reshape(-1, 2)
        xy = xy @ M.T
        xy = xy[:, :2] / xy[:, 2:3] if self.perspective else xy[:, :2]
        return xy.reshape(shp).astype(np.float32)

    def __call__(self, shape: tuple[int, int], labels: dict, rng: random.Random):
        """-> (warp recipe, output shape (h, w), labels)."""
        M, s, w, h = self._matrix(shape, rng)
        warps = self.border[0] != 0 or self.border[1] != 0 or (M != np.eye(3)).any()
        warp = {"M": M if warps else None, "dsize": (w, h), "perspective": bool(self.perspective)}
        bboxes = labels["bboxes"]
        n = len(bboxes)
        if not n:
            return warp, (h, w), labels
        segments = labels["segments"]
        use_segments = segments.size > 0
        if use_segments:  # the boxes follow the warped polygons
            segments = self._apply_points(segments, M)
            new = segments_to_boxes(segments, w, h)
        else:
            xy = self._apply_points(bboxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n, 4, 2), M)
            xy = xy.reshape(n, 8)
            x, y = xy[:, [0, 2, 4, 6]], xy[:, [1, 3, 5, 7]]
            new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
            new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
            new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
        k = labels.get("keypoints")
        if k is not None:
            k = k.copy()
            k[..., :2] = self._apply_points(labels["keypoints"][..., :2], M)
            k = _invisible_outside(k, w, h)
        keep = _box_candidates(bboxes.T * s, new.T, area_thr=0.01 if use_segments else 0.1)
        return warp, (h, w), {**labels, "bboxes": new[keep], "cls": labels["cls"][keep],
                              "segments": segments[keep] if use_segments else segments,
                              "keypoints": None if k is None else k[keep]}


class Mosaic:
    """4- or 9-image mosaic: the canvas recipe and the labels."""

    def __init__(self, dataset, imgsz: int = 640, p: float = 1.0, n: int = 4):
        if n not in (4, 9):
            raise ValueError(f"mosaic grid must be 4 or 9, got {n}")
        self.dataset, self.imgsz, self.p, self.n = dataset, imgsz, p, n

    def __call__(self, index: int, rng: random.Random, tiles: list):
        if self.n == 9:
            return self._mosaic9(index, rng, tiles)
        s = self.imgsz
        yc = int(rng.uniform(s // 2, 2 * s - s // 2))
        xc = int(rng.uniform(s // 2, 2 * s - s // 2))
        indices = [index] + [rng.randrange(len(self.dataset)) for _ in range(3)]
        placed, parts = [], []
        for i, idx in enumerate(indices):
            im, (w, h), labels = self.dataset.load_for_mosaic(idx, s)
            if i == 0:  # top-left
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
            elif i == 1:  # top-right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
            elif i == 2:  # bottom-left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
            else:  # bottom-right
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
            placed.append(_tile(tiles, im, w, h, (y1a, y2a, x1a, x2a), (y1b, y2b, x1b, x2b)))
            parts.append(offset_labels(labels, x1a - x1b, y1a - y1b))
        canvas = {"size": (2 * s, 2 * s), "tiles": placed, "crop": None}
        return canvas, (2 * s, 2 * s), clip_labels(_cat_labels(parts), 2 * s, 2 * s)

    def _mosaic9(self, index: int, rng: random.Random, tiles: list):
        """3x3 grid around a centre tile, cropped to (2s, 2s)."""
        s = self.imgsz
        indices = [index] + [rng.randrange(len(self.dataset)) for _ in range(8)]
        hp = wp = -1  # height, width of the previous tile
        placed, parts = [], []
        for i, idx in enumerate(indices):
            im, (w, h), labels = self.dataset.load_for_mosaic(idx, s)
            if i == 0:  # centre
                c = s, s, s + w, s + h
                h0, w0 = h, w
            elif i == 1:  # top
                c = s, s - h, s + w, s
            elif i == 2:  # top right
                c = s + wp, s - h, s + wp + w, s
            elif i == 3:  # right
                c = s + w0, s, s + w0 + w, s + h
            elif i == 4:  # bottom right
                c = s + w0, s + hp, s + w0 + w, s + hp + h
            elif i == 5:  # bottom
                c = s + w0 - w, s + h0, s + w0, s + h0 + h
            elif i == 6:  # bottom left
                c = s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h
            elif i == 7:  # left
                c = s - w, s + h0 - h, s, s + h0
            else:  # top left
                c = s - w, s + h0 - hp - h, s, s + h0 - hp
            padw, padh = c[:2]
            x1, y1, x2, y2 = (max(x, 0) for x in c)
            sy, sx = y1 - padh, x1 - padw  # img[sy:, sx:][: y2 - y1, : x2 - x1]
            placed.append(_tile(tiles, im, w, h, (y1, y2, x1, x2),
                                (sy, min(h, sy + y2 - y1), sx, min(w, sx + x2 - x1))))
            hp, wp = h, w
            parts.append(offset_labels(labels, padw, padh))
        yc = int(rng.uniform(0, s))
        xc = int(rng.uniform(0, s))
        canvas = {"size": (3 * s, 3 * s), "tiles": placed, "crop": (yc, xc, 2 * s, 2 * s)}
        labels9 = clip_labels(offset_labels(_cat_labels(parts), -xc, -yc), 2 * s, 2 * s)
        if len(labels9["bboxes"]):
            b = labels9["bboxes"]
            labels9 = _index_labels(labels9, (b[:, 2] - b[:, 0] > 2) & (b[:, 3] - b[:, 1] > 2))
        return canvas, (2 * s, 2 * s), labels9


class CopyPaste:
    """Instance copy-paste: each box's pixel rectangle, mirrored, at the
    mirrored x position (its polygon mirrored about the canvas's centre
    line), unless it would cover a box by more than ``iou_thres`` of that
    box's area.  Keypoint datasets paste nothing."""

    def __init__(self, p: float = 0.5, iou_thres: float = 0.3):
        self.p, self.iou_thres = p, iou_thres

    def __call__(self, shape: tuple[int, int], labels: dict, rng: random.Random):
        """-> (paste rectangles (y1, y2, x1, x2, nx1, nx2), labels)."""
        bboxes = labels["bboxes"]
        n = len(bboxes)
        if not n or self.p <= 0 or labels.get("keypoints") is not None:
            return [], labels
        W = shape[1]
        pastes, new_parts = [], []
        for j in range(n):
            if rng.random() >= self.p:
                continue
            x1, y1, x2, y2 = bboxes[j].astype(int)
            w, h = x2 - x1, y2 - y1
            if w < 4 or h < 4:
                continue
            nx1 = W - x2
            nx2 = nx1 + w
            if nx1 < 0 or nx2 > W:
                continue
            cand = np.array([nx1, y1, nx2, y2], np.float32)
            xx1 = np.maximum(cand[0], bboxes[:, 0])
            yy1 = np.maximum(cand[1], bboxes[:, 1])
            xx2 = np.minimum(cand[2], bboxes[:, 2])
            yy2 = np.minimum(cand[3], bboxes[:, 3])
            inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
            area = (bboxes[:, 2] - bboxes[:, 0]) * (bboxes[:, 3] - bboxes[:, 1]) + 1e-9
            if (inter / area).max() > self.iou_thres:
                continue
            pastes.append(tuple(int(v) for v in (y1, y2, x1, x2, nx1, nx2)))
            seg = labels["segments"][j:j + 1].copy()
            if seg.size:  # the polygon mirrored with its rectangle
                seg[..., 0] = W - seg[..., 0]
            new_parts.append({"cls": labels["cls"][j:j + 1], "bboxes": cand[None],
                              "segments": seg, "keypoints": None})
        if new_parts:
            labels = _cat_labels([labels] + new_parts)
        return pastes, labels


@dataclass
class RandomFlip:
    """Flip of the boxes, segments and keypoints (a horizontal flip swaps
    the keypoints by ``flip_idx`` when it has one entry a keypoint); the
    recipe's flag flips the pixels."""

    p: float = 0.5
    direction: str = "horizontal"
    flip_idx: Any = None

    def __call__(self, shape: tuple[int, int], labels: dict, rng: random.Random):
        """-> (flipped, labels)."""
        h, w = shape
        if rng.random() >= self.p:
            return False, labels
        b = labels["bboxes"].copy()
        s = labels["segments"].copy()
        k = labels["keypoints"].copy() if labels.get("keypoints") is not None else None
        if self.direction == "horizontal":
            if len(b):
                x1 = b[:, 0].copy()
                b[:, 0] = w - b[:, 2]
                b[:, 2] = w - x1
            if s.size:
                s[..., 0] = w - s[..., 0]
            if k is not None:
                k[..., 0] = w - k[..., 0]
                if self.flip_idx is not None and len(self.flip_idx) == k.shape[1]:
                    k = np.ascontiguousarray(k[:, np.asarray(self.flip_idx, int), :])
        else:
            if len(b):
                y1 = b[:, 1].copy()
                b[:, 1] = h - b[:, 3]
                b[:, 3] = h - y1
            if s.size:
                s[..., 1] = h - s[..., 1]
            if k is not None:
                k[..., 1] = h - k[..., 1]
        return True, {**labels, "bboxes": b, "segments": s, "keypoints": k}


@dataclass
class RandomHSV:
    """HSV gains drawn as JAX draws them: the recipe's three LUTs, or None
    (no draw) when every gain is 0."""

    hgain: float = 0.015
    sgain: float = 0.7
    vgain: float = 0.4

    def __call__(self, rng: random.Random):
        if not (self.hgain or self.sgain or self.vgain):
            return None
        r = np.array([rng.uniform(-1, 1) for _ in range(3)]) * [
            self.hgain, self.sgain, self.vgain] + 1
        return hsv_luts(r)


@dataclass
class TrainTransforms:
    """The v8 train pipeline's labels and recipe: mosaic -> affine ->
    (mixup) -> copy-paste -> HSV -> flips, or the letterboxed image ->
    affine when the mosaic is off or not drawn."""

    dataset: Any
    imgsz: int = 640
    mosaic: float = 1.0
    mixup: float = 0.0
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    fliplr: float = 0.5
    flipud: float = 0.0
    copy_paste: float = 0.0
    mosaic9: bool = False
    mosaic_enabled: bool = True
    flip_idx: Any = None

    def __post_init__(self):
        if self.imgsz % 2:
            raise ValueError(f"train imgsz must be even (the mosaic's border is imgsz // 2), "
                             f"got {self.imgsz}")
        self._mosaic = Mosaic(self.dataset, self.imgsz, self.mosaic, n=9 if self.mosaic9 else 4)
        self._copy_paste = CopyPaste(self.copy_paste)
        geo = dict(degrees=self.degrees, translate=self.translate, scale=self.scale,
                   shear=self.shear, perspective=self.perspective)
        self._affine = RandomPerspective(**geo, border=(-self.imgsz // 2, -self.imgsz // 2))
        self._affine_plain = RandomPerspective(**geo)
        self._hsv = RandomHSV(self.hsv_h, self.hsv_s, self.hsv_v)
        if importlib.util.find_spec("albumentations") is not None:  # JAX's optional hook
            print("train: albumentations is installed, but its transforms are not ported; "
                  "they are not applied")
        self._letterbox = LetterBox((self.imgsz, self.imgsz))

    def _mosaic_warped(self, index: int, rng: random.Random, tiles: list):
        canvas, shape, labels = self._mosaic(index, rng, tiles)
        warp, shape, labels = self._affine(shape, labels, rng)
        return canvas, warp, shape, labels

    def __call__(self, index: int, rng: random.Random):
        """-> (recipe, tiles, labels {cls int64, bboxes float32 xyxy px,
        segments (n, P, 2) px, keypoints (n, K, 3) px or None})."""
        tiles: list[np.ndarray] = []
        mix = None
        use_mosaic = self.mosaic_enabled and rng.random() < self.mosaic
        if use_mosaic:
            canvas, warp, shape, labels = self._mosaic_warped(index, rng, tiles)
            if self.mixup and rng.random() < self.mixup:
                canvas2, warp2, _, labels2 = self._mosaic_warped(
                    rng.randrange(len(self.dataset)), rng, tiles)
                mix = {"canvas": canvas2, "warp": warp2, "r": mixup_ratio(rng)}
                labels = _cat_labels([labels, labels2])
        else:
            im, (w, h), labels = self.dataset.load_for_mosaic(index, self.imgsz)
            (nw, nh), _, (left, top, right, bottom) = self._letterbox.geometry((h, w))
            labels, _ = self._letterbox.place_labels(labels, (h, w))
            shape = (nh + top + bottom, nw + left + right)
            canvas = {"size": shape, "crop": None,
                      "tiles": [_tile(tiles, im, w, h, (top, top + nh, left, left + nw),
                                      (0, nh, 0, nw), [] if (nw, nh) == (w, h) else [(nw, nh)])]}
            warp, shape, labels = self._affine_plain(shape, labels, rng)
        paste = []
        if self.copy_paste:
            paste, labels = self._copy_paste(shape, labels, rng)
        hsv = self._hsv(rng)
        flipud, labels = RandomFlip(self.flipud, "vertical")(shape, labels, rng)
        fliplr, labels = RandomFlip(self.fliplr, "horizontal", self.flip_idx)(shape, labels, rng)
        if shape != (self.imgsz, self.imgsz):
            raise AssertionError(f"train image of shape {shape}, expected imgsz {self.imgsz}")
        recipe = {"canvas": canvas, "warp": warp, "mixup": mix, "paste": paste, "hsv": hsv,
                  "flipud": flipud, "fliplr": fliplr}
        labels = {**labels, "cls": labels["cls"].astype(np.int64),
                  "bboxes": labels["bboxes"].astype(np.float32)}
        return recipe, tiles, labels


@dataclass
class ClassifyAugment:
    """Classification train transform of one decoded image, drawn as JAX's
    ``ClassifyAugment`` draws it: the crop of torchvision's
    ``RandomResizedCrop`` (10 tries of an area fraction in ``scale`` and a
    log-uniform aspect ratio in ``ratio``, sides by ``round``; then the
    centre crop clamped to the ratio range) resized to ``size``, the flips,
    the HSV gains and torchvision's ``RandomErasing(value=0)`` rectangle
    (10 tries of an area fraction in [0.02, 0.33] and a log-uniform ratio
    in [0.3, 3.3], strictly inside the image)."""

    size: int = 224
    scale: tuple = (0.08, 1.0)
    ratio: tuple = (3.0 / 4.0, 4.0 / 3.0)
    hflip: float = 0.5
    vflip: float = 0.0
    hsv_h: float = 0.015
    hsv_s: float = 0.4
    hsv_v: float = 0.4
    erasing: float = 0.0

    def __post_init__(self):
        self._hsv = RandomHSV(self.hsv_h, self.hsv_s, self.hsv_v)

    def _crop(self, h: int, w: int, rng: random.Random) -> tuple:
        area = h * w
        log_r = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target = area * rng.uniform(*self.scale)
            ar = math.exp(rng.uniform(*log_r))
            cw = round(math.sqrt(target * ar))
            ch = round(math.sqrt(target / ar))
            if 0 < cw <= w and 0 < ch <= h:
                top = rng.randint(0, h - ch)
                left = rng.randint(0, w - cw)
                return top, left, ch, cw
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, round(w / self.ratio[0])
        elif in_ratio > self.ratio[1]:
            cw, ch = round(h * self.ratio[1]), h
        else:
            cw, ch = w, h
        return (h - ch) // 2, (w - cw) // 2, ch, cw

    def _erase(self, rng: random.Random):
        h = w = self.size
        area = h * w
        for _ in range(10):
            target = area * rng.uniform(0.02, 0.33)
            ar = math.exp(rng.uniform(math.log(0.3), math.log(3.3)))
            ew = round(math.sqrt(target * ar))
            eh = round(math.sqrt(target / ar))
            if 0 < ew < w and 0 < eh < h:
                return rng.randint(0, h - eh), rng.randint(0, w - ew), eh, ew
        return None

    def __call__(self, shape: tuple[int, int], rng: random.Random) -> dict:
        """The recipe of an image of ``shape`` (h, w)."""
        crop = self._crop(*shape, rng)
        fliplr = self.hflip > 0.0 and rng.random() < self.hflip
        flipud = self.vflip > 0.0 and rng.random() < self.vflip
        hsv = self._hsv(rng)
        erase = self._erase(rng) if self.erasing > 0.0 and rng.random() < self.erasing else None
        return {"crop": crop, "size": self.size, "fliplr": fliplr, "flipud": flipud,
                "hsv": hsv, "erase": erase}
