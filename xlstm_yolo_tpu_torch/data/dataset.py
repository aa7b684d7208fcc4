"""YOLO-format detection dataset, val mode (counterpart of
``check_det_dataset``, ``img2label_path`` and ``YOLODataset`` in
``xlstm_yolo_tpu/data/dataset.py``).

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

The work is split by where it runs: a sample (:meth:`YOLODataset.get_sample`,
in the loader's worker processes) is the decoded BGR image and its labels
in the letterboxed frame, which need no pixels; :meth:`YOLODataset.images`
resizes, pads and flips a collated batch to RGB on the validator's device,
OpenCV-exact (``augment.resize_linear_u8``).  There is no label cache: the
labels are parsed anew each time (the JAX package's ``.xyt_labels_*.cache.npz``
files beside the images are never read).  Only the detect task's val mode is
ported; training augmentation and the other tasks are not.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import yaml

from xlstm_yolo_tpu_torch.data.augment import LetterBox, resize_linear_u8, val_resized_shape
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
    """Detection dataset in val mode: scan, parse labels, serve samples."""

    def __init__(self, img_path: str, imgsz: int = 640, max_targets: int = 128,
                 single_cls: bool = False):
        self.imgsz = imgsz
        self.max_targets = max_targets
        self.single_cls = single_cls
        self.im_files = self._scan_images(img_path)
        self.labels = self._load_labels()
        self.letterbox = LetterBox((imgsz, imgsz), auto=False, scaleup=True)

    @staticmethod
    def _scan_images(img_path: str) -> list[str]:
        p = Path(img_path)
        if p.is_dir():
            files = sorted(str(f) for f in p.rglob("*.*") if f.suffix.lower() in IMG_EXTS)
        elif p.is_file() and p.suffix == ".txt":  # file list
            files = [ln.strip() for ln in p.read_text().splitlines() if ln.strip()]
        else:
            raise FileNotFoundError(f"dataset path not found: {img_path}")
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
        return imread(self.im_files[i])

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

    def get_sample(self, i: int) -> dict:
        """-> dict(im0 uint8 BGR HWC as decoded, resized_shape (hr, wr), cls,
        bboxes xyxy px in the letterboxed frame, mask (padded to
        max_targets), im_file, orig_shape, ratio_pad)."""
        im = self.load_image(i)
        h0, w0 = im.shape[:2]
        hr, wr = val_resized_shape((h0, w0), self.imgsz)
        labels0 = self._px_labels(i, wr, hr)
        labels, (_, pad) = self.letterbox.place_labels(labels0, (hr, wr))
        cls, bboxes = labels0["cls"], labels["bboxes"]
        M = self.max_targets
        n = min(len(cls), M)
        cls_p = np.zeros((M,), np.int32)
        box_p = np.zeros((M, 4), np.float32)
        mask = np.zeros((M,), bool)
        if n:
            cls_p[:n] = cls[:n]
            box_p[:n] = bboxes[:n]
            mask[:n] = True
        return {"im0": im, "resized_shape": (hr, wr), "cls": cls_p, "bboxes": box_p,
                "mask": mask, "im_file": self.im_files[i], "orig_shape": (h0, w0),
                "ratio_pad": ((hr / h0, wr / w0), pad)}

    @staticmethod
    def collate(samples: list[dict]) -> dict:
        return {
            "im0": [s["im0"] for s in samples],
            "resized_shape": [s["resized_shape"] for s in samples],
            "cls": np.stack([s["cls"] for s in samples]),
            "bboxes": np.stack([s["bboxes"] for s in samples]),
            "mask": np.stack([s["mask"] for s in samples]),
            "im_file": [s["im_file"] for s in samples],
            "orig_shape": [s["orig_shape"] for s in samples],
            "ratio_pad": [s["ratio_pad"] for s in samples],
        }

    def images(self, batch: dict, device: str | torch.device) -> torch.Tensor:
        """A collated batch's images resized, letterboxed and flipped to RGB
        on ``device``: uint8 (B, imgsz, imgsz, 3)."""
        out = []
        for im0, (hr, wr) in zip(batch["im0"], batch["resized_shape"]):
            im = torch.from_numpy(np.ascontiguousarray(im0)).to(device)
            if im.shape[:2] != (hr, wr):
                im = resize_linear_u8(im, wr, hr)
            out.append(self.letterbox(im)[0].flip(-1))  # BGR -> RGB
        return torch.stack(out)
