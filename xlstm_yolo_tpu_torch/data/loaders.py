"""Inference source loaders: image files, directories, globs, in-memory
arrays and tensors, as ``(paths, bgr_images, infos)`` batches.

Counterpart of ``xlstm_yolo_tpu/data/loaders.py``: the same dispatch
(:func:`load_inference_source`), file order and batches.  Files are read
by :func:`data.imread.imread` (PNG and JPEG, byte-equal to
``cv2.imread``).  A file that ``cv2.imread`` returns None for (corrupt
data) is skipped, as JAX's loader skips it; a file in a format the port
cannot decode yet (WebP, TIFF, BMP, ...) raises, naming the format.
Video files, streams and screenshots need a video decoder and a screen
grabber the port does not have: they raise ``NotImplementedError``
(ROADMAP item 6).
"""

from __future__ import annotations

import glob
import time
from pathlib import Path
from typing import Iterator

import numpy as np

from xlstm_yolo_tpu_torch.data.imread import CorruptImageError, imread

IMG_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp", "pfm"}
VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv", "webm"}
_NOT_PORTED = "is not ported yet (ROADMAP item 6: video, streams and screenshots)"


class LoadImagesAndVideos:
    """Image files of paths, directories (recursive) and globs, in JAX's order.

    ``decode_s`` accumulates the seconds spent reading and decoding."""

    def __init__(self, path, batch: int = 1, vid_stride: int = 1):
        files = []
        for p in path if isinstance(path, (list, tuple)) else [path]:
            p = str(p)
            if "*" in p:
                files.extend(sorted(glob.glob(p, recursive=True)))
            elif Path(p).is_dir():
                files.extend(sorted(glob.glob(str(Path(p) / "**" / "*.*"), recursive=True)))
            elif Path(p).is_file():
                files.append(p)
            else:
                raise FileNotFoundError(f"source not found: {p}")
        self.files = [
            f for f in files if f.rsplit(".", 1)[-1].lower() in IMG_FORMATS | VID_FORMATS
        ]
        if not self.files:
            raise FileNotFoundError(f"no images/videos in source {path}")
        videos = [f for f in self.files if f.rsplit(".", 1)[-1].lower() in VID_FORMATS]
        if videos:
            raise NotImplementedError(f"video file {videos[0]}: video decoding {_NOT_PORTED}")
        self.batch = batch
        self.vid_stride = vid_stride
        self.mode = "image"
        self.decode_s = 0.0

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator:
        paths, imgs, infos = [], [], []
        for f in self.files:
            t0 = time.perf_counter()
            try:
                im = imread(f)
            except CorruptImageError:  # cv2.imread returns None: JAX skips the file
                continue
            finally:
                self.decode_s += time.perf_counter() - t0
            paths.append(f)
            imgs.append(im)
            infos.append(f"image {f}")
            if len(imgs) == self.batch:
                yield paths, imgs, infos
                paths, imgs, infos = [], [], []
        if imgs:
            yield paths, imgs, infos


class LoadPilAndNumpy:
    """In-memory images: numpy BGR arrays, or PIL-like objects (anything with
    ``.mode`` and ``.convert("RGB")``; PIL is not imported)."""

    def __init__(self, imgs, batch: int | None = None):
        if not isinstance(imgs, (list, tuple)):
            imgs = [imgs]
        self.imgs = [self._as_bgr(im) for im in imgs]
        self.paths = [getattr(im, "filename", f"image{i}.jpg") for i, im in enumerate(imgs)]
        self.batch = batch or len(self.imgs)
        self.mode = "image"

    @staticmethod
    def _as_bgr(im):
        if hasattr(im, "mode"):  # PIL
            arr = np.asarray(im.convert("RGB"))
            return np.ascontiguousarray(arr[..., ::-1])
        return np.asarray(im)

    def __len__(self):
        return len(self.imgs)

    def __iter__(self):
        for i in range(0, len(self.imgs), self.batch):
            sl = slice(i, i + self.batch)
            yield self.paths[sl], self.imgs[sl], [""] * len(self.imgs[sl])


class LoadTensor:
    """Pre-batched tensors (torch or numpy, BCHW or BHWC, uint8 or float 0-1),
    RGB, as one batch."""

    def __init__(self, tensor):
        if hasattr(tensor, "detach"):  # torch
            tensor = tensor.detach().cpu().numpy()
        arr = np.asarray(tensor)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.ndim != 4:
            raise ValueError(f"expected a 3/4-D tensor, got {arr.shape}")
        if arr.shape[1] in (1, 3) and arr.shape[-1] not in (1, 3):  # BCHW -> BHWC
            arr = arr.transpose(0, 2, 3, 1)
        if arr.dtype != np.uint8:
            if arr.max() > 1.0 + 1e-3:
                raise ValueError("float tensor sources must be 0-1")
            arr = (arr * 255).astype(np.uint8)
        self.imgs = [np.ascontiguousarray(a[..., ::-1]) for a in arr]  # RGB->BGR
        self.paths = [f"tensor{i}.jpg" for i in range(len(self.imgs))]
        self.batch = len(self.imgs)
        self.mode = "image"

    def __len__(self):
        return len(self.imgs)

    def __iter__(self):
        yield self.paths, self.imgs, [""] * len(self.imgs)


def load_inference_source(source, batch: int = 1, vid_stride: int = 1):
    """The loader of ``source``, dispatched as JAX's ``load_inference_source``."""
    if isinstance(source, (str, Path)):
        s = str(source)
        if s.startswith("screen"):
            raise NotImplementedError(f"screenshot source {s!r} {_NOT_PORTED}")
        if s.isnumeric() or s.startswith(("rtsp://", "rtmp://", "http://", "https://", "tcp://")):
            raise NotImplementedError(f"stream source {s!r} {_NOT_PORTED}")
        return LoadImagesAndVideos(source, batch=batch, vid_stride=vid_stride)
    if isinstance(source, np.ndarray) and source.ndim == 4:
        return LoadTensor(source)
    if hasattr(source, "device") and hasattr(source, "ndim"):  # torch tensor
        return LoadTensor(source)
    if isinstance(source, np.ndarray) or hasattr(source, "mode"):
        return LoadPilAndNumpy(source, batch=batch)
    if isinstance(source, (list, tuple)):
        if source and isinstance(source[0], (str, Path)):
            return LoadImagesAndVideos(list(source), batch=batch, vid_stride=vid_stride)
        return LoadPilAndNumpy(list(source), batch=batch)
    raise TypeError(f"unsupported source type {type(source)}")
