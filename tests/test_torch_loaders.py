"""The port's inference source loaders against the JAX package's.

``load_inference_source`` on the same sources (a nested directory of JPEG
and PNG files with a corrupt file and a text file among them, a glob, a
list of paths, one path, numpy images, a PIL image, a BHWC uint8 array, a
BCHW float tensor) gives what JAX's gives: the same batches, paths, infos
and image bytes, exactly.  The port skips a file ``cv2.imread`` returns
None for, as JAX does, and raises where JAX would read a format the port
cannot decode yet, or a video, a stream or a screenshot source."""

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from xlstm_yolo_tpu.data import loaders as jax_loaders
from xlstm_yolo_tpu_torch.data import loaders
from xlstm_yolo_tpu_torch.data.imread import encode_png

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin


def write_tree(root):
    rng = np.random.default_rng(0)
    (root / "sub" / "deeper").mkdir(parents=True)
    for j, (h, w) in enumerate([(40, 60), (33, 17), (64, 64), (21, 90), (50, 41)]):
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        folder = root if j < 2 else root / "sub" if j < 4 else root / "sub" / "deeper"
        if j % 2:
            (folder / f"im{j}.png").write_bytes(encode_png(im))
        else:
            cv2.imwrite(str(folder / f"im{j}.jpg"), im, [cv2.IMWRITE_JPEG_QUALITY, 70 + j])
    (root / "sub" / "broken.jpg").write_bytes(b"\xff\xd8\xff\xd9")  # cv2.imread: None
    (root / "notes.txt").write_text("not an image")
    return root


def batches(loader):
    return [(list(p), [im.tobytes() + str(im.shape).encode() for im in ims], list(i))
            for p, ims, i in loader]


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_directory_glob_and_paths_match_jax(tmp_path, batch):
    root = write_tree(tmp_path)
    sources = [str(root), str(root / "**" / "*.jpg"), [str(root / "im1.png"), str(root / "im0.jpg")],
               str(root / "sub" / "im2.jpg")]
    for source in sources:
        got = loaders.load_inference_source(source, batch=batch)
        ref = jax_loaders.load_inference_source(source, batch=batch)
        assert got.files == ref.files and len(got) == len(ref)
        assert batches(got) == batches(ref), source
    assert sum(len(b[0]) for b in batches(loaders.load_inference_source(str(root)))) == 5


def test_in_memory_sources_match_jax():
    rng = np.random.default_rng(1)
    ims = [rng.integers(0, 256, (30 + j, 40, 3), dtype=np.uint8) for j in range(3)]
    bhwc = rng.integers(0, 256, (2, 16, 24, 3), dtype=np.uint8)
    bchw = torch.from_numpy(rng.random((2, 3, 16, 24), dtype=np.float32))
    pil = Image.fromarray(ims[0][..., ::-1])
    cases = [(ims[0], 1), (ims, 2), (ims, None), (bhwc, 1), (bchw, 1), (pil, 1), ([pil, ims[1]], 1)]
    for source, batch in cases:
        got = loaders.load_inference_source(source, batch=batch)
        ref = jax_loaders.load_inference_source(source, batch=batch)
        assert type(got).__name__ == type(ref).__name__
        assert batches(got) == batches(ref)


def test_refusals(tmp_path):
    im = np.zeros((8, 8, 3), np.uint8)
    assert cv2.imwrite(str(tmp_path / "a.webp"), im)
    loader = loaders.load_inference_source(str(tmp_path / "a.webp"))
    with pytest.raises(ValueError, match="a.webp.*WebP"):
        list(loader)
    (tmp_path / "clip.mp4").write_bytes(b"\x00" * 16)
    with pytest.raises(NotImplementedError, match="clip.mp4.*ROADMAP item 6"):
        loaders.load_inference_source(str(tmp_path / "clip.mp4"))
    for source in ("0", "rtsp://host/stream", "screen 0"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
            loaders.load_inference_source(source)
    with pytest.raises(FileNotFoundError):
        loaders.load_inference_source(str(tmp_path / "absent.jpg"))
    with pytest.raises(TypeError):
        loaders.load_inference_source(3.5)
