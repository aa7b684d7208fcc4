"""YOLO-format detection dataset (counterpart of ``check_det_dataset``,
``img2label_path`` and ``YOLODataset`` in ``xlstm_yolo_tpu/data/dataset.py``),
val and train mode.

The on-disk format is the JAX package's: an images directory (or a .txt
list of image paths), ``labels/*.txt`` beside it with one normalised
``class x y w h`` row per box, and a dataset YAML with path/train/val/names.
The val protocol is the JAX package's, exactly:

- each image's long side is resized to ``imgsz``, up or down, each side
  ``min(ceil(side * r), imgsz)`` (``augment.val_resized_shape``), then the
  letterbox only pads; ``ratio_pad`` is ``((hr / h0, wr / w0), (left,
  top))``;
- label rows that repeat an earlier row exactly are dropped, first-seen
  order kept; a box row is kept when w, h > 0 and 0 <= xywh <= 1.0001; a
  row of more than 5 values and odd length is a polygon, whose bounding
  box is taken;
- the labels are padded to ``max_targets`` and truncated there.

In train mode (``augment=True`` with ``hyp``, the train config) a sample
goes through ``augment.TrainTransforms`` with the ``random.Random`` the
loader gives its batch: mosaic tiles are loaded with their long side
resized to ``imgsz`` by ``round`` (``load_for_mosaic``, not val's ceil),
and the labels move on the host.  ``fraction`` keeps the first
``max(1, int(n * fraction))`` files; ``cache`` is False, True or ``"ram"``
(decoded images kept in memory, in each worker process) or ``"disk"``
(``.npy`` beside each image, memory-mapped).

The work is split by where it runs: a sample (:meth:`YOLODataset.get_sample`,
in the loader's worker processes) is the decoded BGR image(s) and the
labels, which need no pixels; :meth:`YOLODataset.images` makes a collated
batch's pixels on the device: val's resize, letterbox and BGR -> RGB
(OpenCV-exact, ``augment.resize_linear_u8``), or train's recipes
(``pixels.compose_batch``).  There is no label cache: the labels are
parsed anew each time (the JAX package's ``.xyt_labels_*.cache.npz``
files beside the images are never read).  Only the detect task is ported.
"""

from __future__ import annotations

import random
from pathlib import Path

import numpy as np
import torch
import yaml

from xlstm_yolo_tpu_torch.data.augment import (
    LetterBox,
    TrainTransforms,
    resize_linear_u8,
    val_resized_shape,
)
from xlstm_yolo_tpu_torch.data.imread import imread

IMG_EXTS = {".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp", ".mpo"}


def check_det_dataset(data: str | dict) -> dict:
    """Resolve a dataset YAML into absolute split paths + names."""
    if isinstance(data, (str, Path)):
        p = Path(data)
        with open(p) as fh:
            d = yaml.safe_load(fh)
        d["yaml_dir"] = str(p.parent)
    else:
        d = dict(data)
    root = Path(d.get("path") or d.get("yaml_dir") or ".")
    if not root.is_absolute():
        root = Path(d.get("yaml_dir", ".")) / root
    out = dict(d)
    for split in ("train", "val", "test"):
        if d.get(split):
            sp = Path(d[split])
            out[split] = str(sp if sp.is_absolute() else root / sp)
    names = d.get("names", {})
    if isinstance(names, list):
        names = dict(enumerate(names))
    out["names"] = {int(k): str(v) for k, v in names.items()}
    out["nc"] = d.get("nc", len(out["names"]) or 80)
    return out


def img2label_path(img_path: str) -> str:
    """.../images/.../x.png -> .../labels/.../x.txt (the last ``images``)."""
    parts = list(Path(img_path).parts)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "images":
            parts[i] = "labels"
            break
    return str(Path(*parts).with_suffix(".txt"))


class YOLODataset(torch.utils.data.Dataset):
    """Detection dataset: scan, parse labels, serve samples."""

    def __init__(self, img_path: str, imgsz: int = 640, augment: bool = False, hyp=None,
                 max_targets: int = 128, single_cls: bool = False, cache=False,
                 fraction: float = 1.0):
        self.imgsz = imgsz
        self.max_targets = max_targets
        self.single_cls = single_cls
        self.im_files = self._scan_images(img_path, fraction)
        self.labels = self._load_labels()
        self.cache_mode = {True: "ram", False: None}.get(cache, cache) or None
        self._ims = [None] * len(self.im_files) if self.cache_mode == "ram" else None
        self.transforms = None
        if augment and hyp is not None:
            self.transforms = TrainTransforms(
                dataset=self, imgsz=imgsz,
                **{k: getattr(hyp, k, v) for k, v in (
                    ("mosaic", 1.0), ("mixup", 0.0), ("degrees", 0.0), ("translate", 0.1),
                    ("scale", 0.5), ("shear", 0.0), ("perspective", 0.0), ("hsv_h", 0.015),
                    ("hsv_s", 0.7), ("hsv_v", 0.4), ("fliplr", 0.5), ("flipud", 0.0),
                    ("copy_paste", 0.0))})
        self.letterbox = LetterBox((imgsz, imgsz), auto=False, scaleup=True)

    @staticmethod
    def _scan_images(img_path: str, fraction: float = 1.0) -> list[str]:
        p = Path(img_path)
        if p.is_dir():
            files = sorted(str(f) for f in p.rglob("*.*") if f.suffix.lower() in IMG_EXTS)
        elif p.is_file() and p.suffix == ".txt":  # file list
            files = [ln.strip() for ln in p.read_text().splitlines() if ln.strip()]
        else:
            raise FileNotFoundError(f"dataset path not found: {img_path}")
        if fraction < 1.0:
            files = files[: max(1, int(len(files) * fraction))]
        if not files:
            raise FileNotFoundError(f"no images under {img_path}")
        return files

    def _load_labels(self) -> list[dict]:
        labels = []
        for f in self.im_files:
            lp = Path(img2label_path(f))
            cls, boxes = [], []
            if lp.exists():
                for line in lp.read_text().splitlines():
                    vals = line.split()
                    if len(vals) > 5 and len(vals) % 2 == 1:  # polygon: its bounding box
                        poly = np.array(list(map(float, vals[1:])), np.float32).reshape(-1, 2)
                        x1, y1 = poly.min(0)
                        x2, y2 = poly.max(0)
                        cls.append(0 if self.single_cls else int(float(vals[0])))
                        boxes.append(np.array([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                                              np.float32))
                    elif len(vals) >= 5:
                        xywh = np.array(list(map(float, vals[1:5])), np.float32)
                        if (xywh[2:] > 0).all() and (0 <= xywh).all() and (xywh <= 1.0001).all():
                            cls.append(0 if self.single_cls else int(float(vals[0])))
                            boxes.append(xywh)
            cls_a = np.asarray(cls, np.int64)
            box_a = np.asarray(boxes, np.float32).reshape(-1, 4)
            if len(cls_a):  # drop exact duplicate rows, first-seen order kept
                rows = np.concatenate([cls_a[:, None].astype(np.float32), box_a], 1)
                idx = np.sort(np.unique(rows, axis=0, return_index=True)[1])
                cls_a, box_a = cls_a[idx], box_a[idx]
            labels.append({"cls": cls_a, "bboxes_n": box_a})  # xywh normalised
        return labels

    def __len__(self):
        return len(self.im_files)

    def __getitem__(self, i: int) -> dict:
        return self.get_sample(i)

    def load_image(self, i: int) -> np.ndarray:
        """Image i decoded (BGR), through the cache."""
        if self._ims is not None and self._ims[i] is not None:
            return self._ims[i]
        npy = Path(self.im_files[i]).with_suffix(".npy")
        if self.cache_mode == "disk" and npy.exists():
            return np.load(npy, mmap_mode="r")
        im = imread(self.im_files[i])
        if self.cache_mode == "disk":
            np.save(npy, im)
        elif self._ims is not None:
            self._ims[i] = im
        return im

    def load_for_mosaic(self, i: int, size: int):
        """(image i decoded, (w, h) its long side resized to ``size`` by
        ``round``, its labels in that frame); the resize is the recipe's."""
        im = self.load_image(i)
        h0, w0 = im.shape[:2]
        r = size / max(h0, w0)
        w, h = (round(w0 * r), round(h0 * r)) if r != 1 else (w0, h0)
        return im, (w, h), self._px_labels(i, w, h)

    def _px_labels(self, i: int, w: int, h: int) -> dict:
        """Image i's labels as xyxy pixels of the image scaled to (w, h)."""
        b = self.labels[i]["bboxes_n"]
        if len(b):
            xy = b[:, :2] * [w, h]
            wh = b[:, 2:] * [w, h]
            boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1).astype(np.float32)
        else:
            boxes = np.zeros((0, 4), np.float32)
        return {"cls": self.labels[i]["cls"].copy(), "bboxes": boxes}

    def _padded(self, cls: np.ndarray, bboxes: np.ndarray):
        M = self.max_targets
        n = min(len(cls), M)
        cls_p = np.zeros((M,), np.int32)
        box_p = np.zeros((M, 4), np.float32)
        mask = np.zeros((M,), bool)
        if n:
            cls_p[:n] = cls[:n]
            box_p[:n] = bboxes[:n]
            mask[:n] = True
        return cls_p, box_p, mask

    def get_sample(self, i: int, rng: random.Random | None = None) -> dict:
        """Val: dict(im0 uint8 BGR HWC as decoded, resized_shape (hr, wr),
        cls, bboxes xyxy px in the letterboxed frame, mask (padded to
        max_targets), im_file, orig_shape, ratio_pad).  Train (with
        transforms; ``rng`` draws the augmentation): dict(recipe, tiles,
        cls, bboxes, mask, im_file, orig_shape (imgsz, imgsz), ratio_pad
        None)."""
        if self.transforms is not None:
            recipe, tiles, labels = self.transforms(i, rng)
            cls_p, box_p, mask = self._padded(labels["cls"], labels["bboxes"])
            return {"recipe": recipe, "tiles": tiles, "cls": cls_p, "bboxes": box_p,
                    "mask": mask, "im_file": self.im_files[i],
                    "orig_shape": (self.imgsz, self.imgsz), "ratio_pad": None}
        im = self.load_image(i)
        h0, w0 = im.shape[:2]
        hr, wr = val_resized_shape((h0, w0), self.imgsz)
        labels0 = self._px_labels(i, wr, hr)
        labels, (_, pad) = self.letterbox.place_labels(labels0, (hr, wr))
        cls_p, box_p, mask = self._padded(labels0["cls"], labels["bboxes"])
        return {"im0": im, "resized_shape": (hr, wr), "cls": cls_p, "bboxes": box_p,
                "mask": mask, "im_file": self.im_files[i], "orig_shape": (h0, w0),
                "ratio_pad": ((hr / h0, wr / w0), pad)}

    @staticmethod
    def collate(samples: list[dict]) -> dict:
        per = ("recipe", "tiles") if "recipe" in samples[0] else ("im0", "resized_shape")
        return {
            **{k: [s[k] for s in samples] for k in per},
            "cls": np.stack([s["cls"] for s in samples]),
            "bboxes": np.stack([s["bboxes"] for s in samples]),
            "mask": np.stack([s["mask"] for s in samples]),
            "im_file": [s["im_file"] for s in samples],
            "orig_shape": [s["orig_shape"] for s in samples],
            "ratio_pad": [s["ratio_pad"] for s in samples],
        }

    def images(self, batch: dict, device: str | torch.device) -> torch.Tensor:
        """A collated batch's images on ``device``, uint8 RGB (B, imgsz,
        imgsz, 3): val's resized, letterboxed and flipped to RGB; train's
        composed from their recipes."""
        if "recipe" in batch:
            from xlstm_yolo_tpu_torch.data.pixels import compose_batch

            return compose_batch(batch["recipe"], batch["tiles"], device)
        out = []
        for im0, (hr, wr) in zip(batch["im0"], batch["resized_shape"]):
            im = torch.from_numpy(np.ascontiguousarray(im0)).to(device)
            if im.shape[:2] != (hr, wr):
                im = resize_linear_u8(im, wr, hr)
            out.append(self.letterbox(im)[0].flip(-1))  # BGR -> RGB
        return torch.stack(out)
