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
and the labels move on the host, the segments and keypoints with the
boxes.  A pose dataset without a ``flip_idx`` (the dataset YAML's) does
not flip left-right, as in JAX: the flip would swap the sides'
keypoints.  ``fraction`` keeps the first ``max(1, int(n * fraction))``
files; ``cache`` is False, True or ``"ram"``
(decoded images kept in memory, in each worker process) or ``"disk"``
(``.npy`` beside each image, memory-mapped).

The work is split by where it runs: a sample (:meth:`YOLODataset.get_sample`,
in the loader's worker processes) is the decoded BGR image(s) and the
labels, which need no pixels; :meth:`YOLODataset.images` makes a collated
batch's pixels on the device: val's resize, letterbox and BGR -> RGB
(OpenCV-exact, ``augment.resize_linear_u8``), or train's recipes
(``pixels.compose_batch``).  There is no label cache: the labels are
parsed anew each time (the JAX package's ``.xyt_labels_*.cache.npz``
files beside the images are never read).

``task`` selects the label rows, as JAX's: ``"pose"`` reads keypoint rows
(class, xywh, then K times x y [v], normalised; ``kpt_shape`` (K, nd) from
the dataset YAML, (17, 3) by default), ``"segment"`` and ``"obb"`` keep
each polygon row's points.  A val sample of these tasks also carries
(padded to ``max_targets``) the segment masks at imgsz / 4
(``masks``: each instance's polygon, resampled to ``SEGMENT_RESAMPLE``
points and letterboxed, filled as OpenCV's ``fillPoly``: ``utils.cv``),
the keypoints in letterboxed pixels (``kpts``) or the rotated boxes
(``rboxes``, xywhr from OpenCV's ``minAreaRect`` of the polygon; a box
row's polygon is its corners), made the same way from the transformed
polygons and keypoints in train mode.  :class:`ClassificationDataset` is
JAX's folder dataset, in val mode and in train mode (``augment.
ClassifyAugment``'s recipes).
"""

from __future__ import annotations

import math
import random
from pathlib import Path

import numpy as np
import torch
import yaml

from xlstm_yolo_tpu_torch.data.augment import (
    SEGMENT_RESAMPLE,
    ClassifyAugment,
    LetterBox,
    TrainTransforms,
    resample_segments,
    resize_linear_u8,
    val_resized_shape,
)
from xlstm_yolo_tpu_torch.data.imread import imread
from xlstm_yolo_tpu_torch.utils.cv import fill_poly, min_area_rect

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
                 fraction: float = 1.0, task: str = "detect", kpt_shape=None, flip_idx=None):
        self.imgsz = imgsz
        self.max_targets = max_targets
        self.single_cls = single_cls
        self.task = task
        self.use_keypoints = task == "pose"
        self.kpt_shape = (tuple(kpt_shape) if kpt_shape
                          else (17, 3) if self.use_keypoints else None)
        self.flip_idx = list(flip_idx) if flip_idx else None
        self.im_files = self._scan_images(img_path, fraction)
        self.labels = self._load_labels()
        self.cache_mode = {True: "ram", False: None}.get(cache, cache) or None
        self._ims = [None] * len(self.im_files) if self.cache_mode == "ram" else None
        self.transforms = None
        if augment and hyp is not None:
            fliplr = getattr(hyp, "fliplr", 0.5)
            if self.use_keypoints and not self.flip_idx and fliplr > 0:
                fliplr = 0.0
            self.transforms = TrainTransforms(
                dataset=self, imgsz=imgsz, fliplr=fliplr, flip_idx=self.flip_idx,
                **{k: getattr(hyp, k, v) for k, v in (
                    ("mosaic", 1.0), ("mixup", 0.0), ("degrees", 0.0), ("translate", 0.1),
                    ("scale", 0.5), ("shear", 0.0), ("perspective", 0.0), ("hsv_h", 0.015),
                    ("hsv_s", 0.7), ("hsv_v", 0.4), ("flipud", 0.0), ("copy_paste", 0.0))})
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
        K, nd = self.kpt_shape if self.kpt_shape else (0, 0)
        labels = []
        for f in self.im_files:
            lp = Path(img2label_path(f))
            cls, boxes, segments, kpts = [], [], [], []
            for line in (lp.read_text().splitlines() if lp.exists() else ()):
                vals = line.split()
                c = 0 if self.single_cls else None
                if self.use_keypoints and len(vals) == 5 + K * nd:
                    pts = np.array(list(map(float, vals[5:])), np.float32).reshape(K, nd)
                    if nd == 2:  # visible unless a coordinate is negative
                        vis = np.where((pts[:, 0] < 0) | (pts[:, 1] < 0), 0.0, 1.0)
                        pts = np.concatenate([pts, vis[:, None].astype(np.float32)], 1)
                    box, seg, kpt = np.array(list(map(float, vals[1:5])), np.float32), None, pts
                elif not self.use_keypoints and len(vals) > 5 and len(vals) % 2 == 1:
                    seg = np.array(list(map(float, vals[1:])), np.float32).reshape(-1, 2)
                    x1, y1 = seg.min(0)
                    x2, y2 = seg.max(0)
                    box, kpt = np.array([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                                        np.float32), None
                elif len(vals) >= 5:
                    box, seg, kpt = np.array(list(map(float, vals[1:5])), np.float32), None, None
                    if not ((box[2:] > 0).all() and (0 <= box).all() and (box <= 1.0001).all()):
                        continue
                else:
                    continue
                cls.append(int(float(vals[0])) if c is None else c)
                boxes.append(box)
                segments.append(seg)
                kpts.append(kpt)
            cls_a = np.asarray(cls, np.int64)
            box_a = np.asarray(boxes, np.float32).reshape(-1, 4)
            if len(cls_a):  # drop exact duplicate rows, first-seen order kept
                rows = np.concatenate([cls_a[:, None].astype(np.float32), box_a], 1)
                idx = np.sort(np.unique(rows, axis=0, return_index=True)[1])
                cls_a, box_a = cls_a[idx], box_a[idx]
                segments = [segments[j] for j in idx]
                kpts = [kpts[j] for j in idx]
            lab = {"cls": cls_a, "bboxes_n": box_a, "segments": segments}  # xywh normalised
            if self.use_keypoints:
                lab["keypoints_n"] = (np.stack([k if k is not None else np.zeros((K, 3), np.float32)
                                                for k in kpts])
                                      if kpts else np.zeros((0, K, 3), np.float32))
            labels.append(lab)
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
        """Image i's labels as xyxy pixels of the image scaled to (w, h); for
        segment and OBB its polygons (a box row's: its corners) resampled,
        (n, SEGMENT_RESAMPLE, 2) pixels (other tasks: (n, 0, 2)); for pose
        its keypoints (n, K, 3) (other tasks: None)."""
        lab = self.labels[i]
        b = lab["bboxes_n"]
        if len(b):
            xy = b[:, :2] * [w, h]
            wh = b[:, 2:] * [w, h]
            boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1).astype(np.float32)
        else:
            boxes = np.zeros((0, 4), np.float32)
        out = {"cls": lab["cls"].copy(), "bboxes": boxes,
               "segments": np.zeros((len(b), 0, 2), np.float32), "keypoints": None}
        if self.task in ("segment", "obb"):
            polys = []
            for j, seg in enumerate(lab["segments"]):
                if seg is not None and len(seg) >= 3:
                    polys.append(seg * [w, h])
                else:
                    x1, y1, x2, y2 = boxes[j]
                    polys.append(np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.float32))
            out["segments"] = (resample_segments(polys) if polys
                               else np.zeros((0, SEGMENT_RESAMPLE, 2), np.float32))
        elif self.use_keypoints:
            k = lab["keypoints_n"].copy()
            k[..., 0] *= w
            k[..., 1] *= h
            out["keypoints"] = k
        return out

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
            sample = {"recipe": recipe, "tiles": tiles, "cls": cls_p, "bboxes": box_p,
                      "mask": mask, "im_file": self.im_files[i],
                      "orig_shape": (self.imgsz, self.imgsz), "ratio_pad": None}
            return self._task_targets(sample, labels)
        im = self.load_image(i)
        h0, w0 = im.shape[:2]
        hr, wr = val_resized_shape((h0, w0), self.imgsz)
        labels0 = self._px_labels(i, wr, hr)
        labels, (_, pad) = self.letterbox.place_labels(labels0, (hr, wr))
        cls_p, box_p, mask = self._padded(labels0["cls"], labels["bboxes"])
        sample = {"im0": im, "resized_shape": (hr, wr), "cls": cls_p, "bboxes": box_p,
                  "mask": mask, "im_file": self.im_files[i], "orig_shape": (h0, w0),
                  "ratio_pad": ((hr / h0, wr / w0), pad)}
        return self._task_targets(sample, labels)

    def _task_targets(self, sample: dict, labels: dict) -> dict:
        """``sample`` with its task's padded targets from the final pixel
        ``labels``: segment's masks at imgsz / 4 (each polygon's points / 4,
        truncated to int32, filled), OBB's minAreaRect xywhr, pose's
        keypoints."""
        M, n = self.max_targets, len(labels["cls"])
        if self.task == "segment":
            ms = self.imgsz // 4  # the prototypes' grid
            masks = np.zeros((M, ms, ms), np.uint8)
            for j, seg in enumerate(labels["segments"][:min(n, M)]):
                fill_poly(masks[j], (seg / 4.0).astype(np.int32), 1)
            sample["masks"] = masks
        elif self.task == "obb":
            rb = np.zeros((M, 5), np.float32)
            for j, seg in enumerate(labels["segments"][:min(n, M)]):
                (cx, cy), (bw, bh), ang = min_area_rect(seg.astype(np.float32))
                rb[j] = [cx, cy, bw, bh, ang * math.pi / 180.0]
            sample["rboxes"] = rb
        elif self.use_keypoints:
            kp = np.zeros((M, self.kpt_shape[0], 3), np.float32)
            kp[:min(n, M)] = labels["keypoints"][:M]
            sample["kpts"] = kp
        return sample

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
            **{k: np.stack([s[k] for s in samples]) for k in ("masks", "kpts", "rboxes")
               if k in samples[0]},
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


class ClassificationDataset(torch.utils.data.Dataset):
    """Folder dataset ``root/<class name>/*.<image>``, classes in sorted order.
    Val mode: the short side resized to ``int(imgsz / crop_fraction)``
    (each side at least that, ``round``) with OpenCV's uint8 INTER_LINEAR,
    then the centre ``imgsz`` x ``imgsz`` crop.  Train mode (``augment``):
    ``augment.ClassifyAugment`` with the train config's keys as JAX maps
    them (``scale`` -> the crop's area range (1 - scale, 1), ``fliplr``,
    ``flipud``, ``hsv_h/s/v``, ``erasing``), drawn with the loader's
    ``random.Random``; the worker cuts the crop.  A sample is the decoded
    image (or crop) and its geometry; :meth:`images` makes the batch's
    pixels on the device, as :class:`YOLODataset` does."""

    transforms = None  # no mosaic for the train loader to switch

    def __init__(self, root: str, imgsz: int = 224, augment: bool = False, hyp=None,
                 fraction: float = 1.0):
        self.root = Path(root)
        self.imgsz = imgsz
        get = hyp.get if isinstance(hyp, dict) else lambda k, d=None: getattr(hyp, k, d)
        self.crop_fraction = float((get("crop_fraction", 1.0) if hyp is not None else 1.0) or 1.0)
        self.transform = None
        if augment:
            def g(k, d):
                return float(get(k, d) if hyp is not None else d)

            self.transform = ClassifyAugment(
                size=imgsz, scale=(1.0 - g("scale", 0.5), 1.0), hflip=g("fliplr", 0.5),
                vflip=g("flipud", 0.0), hsv_h=g("hsv_h", 0.015), hsv_s=g("hsv_s", 0.4),
                hsv_v=g("hsv_v", 0.4), erasing=g("erasing", 0.0))
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        if not classes:
            raise FileNotFoundError(f"no class folders under {root}")
        self.names = dict(enumerate(classes))
        self.samples = [(str(f), i) for i, c in enumerate(classes)
                        for f in sorted((self.root / c).rglob("*.*"))
                        if f.suffix.lower() in IMG_EXTS]
        if fraction < 1.0:  # per class, so that every class keeps a sample
            by_cls: dict[int, list] = {}
            for smp in self.samples:
                by_cls.setdefault(smp[1], []).append(smp)
            self.samples = [smp for lst in by_cls.values()
                            for smp in lst[: max(1, int(len(lst) * fraction))]]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        return self.get_sample(i)

    def get_sample(self, i: int, rng: random.Random | None = None) -> dict:
        """Val: dict(im0, resized_shape, crop (top, left), cls, im_file).
        Train (``rng`` draws the augmentation): dict(recipe, tile (the crop,
        BGR), cls, im_file)."""
        path, label = self.samples[i]
        im = imread(path)
        h, w = im.shape[:2]
        if self.transform is not None:
            recipe = self.transform((h, w), rng)
            top, left, ch, cw = recipe["crop"]
            tile = np.ascontiguousarray(im[top:top + ch, left:left + cw])
            return {"recipe": recipe, "tile": tile, "cls": label, "im_file": path}
        size = int(self.imgsz / self.crop_fraction)
        s = size / min(h, w)
        wr, hr = max(size, round(w * s)), max(size, round(h * s))
        return {"im0": im, "resized_shape": (hr, wr), "cls": label, "im_file": path,
                "crop": ((hr - self.imgsz) // 2, (wr - self.imgsz) // 2)}

    @staticmethod
    def collate(samples: list[dict]) -> dict:
        per = ("recipe", "tile") if "recipe" in samples[0] else ("im0", "resized_shape", "crop")
        return {**{k: [s[k] for s in samples] for k in per},
                "cls": np.asarray([s["cls"] for s in samples], np.int32),
                "im_file": [s["im_file"] for s in samples]}

    def images(self, batch: dict, device: str | torch.device) -> torch.Tensor:
        """The batch's uint8 RGB (B, imgsz, imgsz, 3) images on ``device``:
        val's resized centre crops, train's composed from their recipes."""
        if "recipe" in batch:
            from xlstm_yolo_tpu_torch.data.pixels import compose_classify

            return compose_classify(batch["recipe"], batch["tile"], device)
        out = []
        for im0, (hr, wr), (top, left) in zip(batch["im0"], batch["resized_shape"],
                                               batch["crop"]):
            im = resize_linear_u8(torch.from_numpy(np.ascontiguousarray(im0)).to(device), wr, hr)
            out.append(im[top:top + self.imgsz, left:left + self.imgsz].flip(-1))
        return torch.stack(out)
