"""The port's train dataset and loader held against the JAX package's, on
the CPU.

A set of 12 PNG files of mixed shapes (wider, taller, square, smaller and
larger than ``imgsz``) with 1-6 boxes each, one image unlabelled, at imgsz
160 and batch 4, the default train config (mosaic 1.0, translate 0.1,
scale 0.5, HSV 0.015/0.7/0.4, fliplr 0.5).  JAX's batches are
``build_yolo_dataset(mode="train")`` + ``DataLoader._iter_epoch(epoch)``;
the port's are ``TrainLoader.iter_epoch(epoch)`` composed on the CPU
(``YOLODataset.images``).  Over two epochs, the second after the
``close_mosaic`` switch, the images are byte-equal and ``cls``,
``bboxes``, ``mask`` and ``im_file`` equal exactly, with workers 0 and 2
(spawned processes).  Also ``fraction`` and ``cache="ram"``/``"disk"``.
"""

import random
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from xlstm_yolo_tpu.cfg import get_cfg
from xlstm_yolo_tpu.data.build import DataLoader as JaxDataLoader
from xlstm_yolo_tpu.data.build import build_yolo_dataset as jax_build_dataset
from xlstm_yolo_tpu_torch.cfg import get_cfg as port_get_cfg
from xlstm_yolo_tpu_torch.data.build import TrainLoader, build_yolo_dataset
from xlstm_yolo_tpu_torch.data.imread import imwrite_png

IMGSZ, BATCH = 160, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, where torch's default of a thread per core oversubscribes
    the cores (a tiny step took 50x as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SHAPES = [(120, 160), (200, 140), (160, 160), (97, 211), (300, 420), (64, 48)]


def write_train_set(root: Path, n: int, seed: int, split: str = "train") -> Path:
    """``n`` PNG files cycling through SHAPES with random boxes (image 3
    unlabelled) under root/images/<split>; returns the data YAML."""
    rng = np.random.default_rng(seed)
    (root / "images" / split).mkdir(parents=True, exist_ok=True)
    (root / "labels" / split).mkdir(parents=True, exist_ok=True)
    for j in range(n):
        h, w = SHAPES[j % len(SHAPES)]
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // w, yy * 255 // h, (xx * 3 + yy * 5) % 256], -1)
        im = (base + rng.integers(-40, 40, (h, w, 3))).clip(0, 255).astype(np.uint8)
        imwrite_png(root / "images" / split / f"im{j:03d}.png", im, level=1)
        if j == 3:
            continue
        rows = []
        for _ in range(int(rng.integers(1, 7))):
            cx, cy = rng.uniform(0.15, 0.85, 2)
            bw, bh = rng.uniform(0.08, 0.5, 2)
            rows.append(f"{int(rng.integers(0, 5))} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}\n")
        (root / "labels" / split / f"im{j:03d}.txt").write_text("".join(rows))
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(root), "train": f"images/{split}",
                                    "val": f"images/{split}", "names": [f"c{i}" for i in range(5)]}))
    return data


def config(get, overrides: dict):
    """The train config; ``cache`` is set after ``get_cfg``, whose coercion
    of that boolean key turns a string into False (in both packages)."""
    cfg = get(overrides={"imgsz": IMGSZ, **{k: v for k, v in overrides.items() if k != "cache"}})
    cfg.cache = overrides.get("cache", cfg.cache)
    return cfg


def jax_batches(img_dir: str, overrides: dict, epochs: int):
    cfg = config(get_cfg, overrides)
    ds = jax_build_dataset(cfg, img_dir, BATCH, {}, mode="train")
    loader = JaxDataLoader(ds, batch_size=BATCH, shuffle=True, workers=2, seed=0)
    out = []
    for epoch in range(epochs):
        if epoch == 1:
            ds.transforms.mosaic_enabled = False
        out.append(list(loader._iter_epoch(epoch)))
    return out


def port_batches(img_dir: str, overrides: dict, epochs: int, workers: int):
    cfg = config(port_get_cfg, overrides)
    ds = build_yolo_dataset(cfg, img_dir, mode="train")
    assert ds.cache_mode == overrides.get("cache")
    loader = TrainLoader(ds, batch_size=BATCH, shuffle=True, workers=workers, seed=0)
    out = []
    try:
        for epoch in range(epochs):
            if epoch == 1:
                ds.transforms.mosaic_enabled = False
            out.append([{**b, "img": ds.images(b, "cpu").numpy()}
                        for b in loader.iter_epoch(epoch)])
    finally:
        loader.close()
    return out


def assert_same(got, ref):
    assert len(got) == len(ref)
    for ep_got, ep_ref in zip(got, ref):
        assert len(ep_got) == len(ep_ref) > 0
        for g, r in zip(ep_got, ep_ref):
            assert g["im_file"] == r["im_file"]
            assert g["img"].dtype == r["img"].dtype == np.uint8
            diff = g["img"] != r["img"]
            assert not diff.any(), f"{int(diff.sum())} bytes differ in {r['im_file']}"
            for key in ("cls", "bboxes", "mask"):
                np.testing.assert_array_equal(g[key], r[key], err_msg=key)


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainset")
    write_train_set(root, 12, seed=3)
    img_dir = str(root / "images" / "train")
    return img_dir, jax_batches(img_dir, {}, 2)


@pytest.mark.parametrize("workers", [0, 2])
def test_train_batches_match_jax(train_set, workers):
    img_dir, ref = train_set
    got = port_batches(img_dir, {}, 2, workers)
    assert_same(got, ref)
    assert any(b["mask"].any() for ep in got for b in ep)


def test_fraction_and_ram_cache_match_jax(train_set):
    img_dir, _ = train_set
    over = {"fraction": 0.75, "cache": "ram"}
    ref = jax_batches(img_dir, over, 1)
    got = port_batches(img_dir, over, 1, 0)
    assert len(ref[0]) == 9 // BATCH
    assert_same(got, ref)


def test_disk_cache_writes_npy_and_reads_it(tmp_path):
    write_train_set(tmp_path, 4, seed=4)
    img_dir = str(tmp_path / "images" / "train")
    cfg = config(port_get_cfg, {"cache": "disk"})
    assert port_get_cfg(overrides={"cache": "disk"}).cache is False
    first = build_yolo_dataset(cfg, img_dir, mode="train")
    rng = random.Random(0)
    a = [first.get_sample(i, rng) for i in range(4)]
    assert len(list(Path(img_dir).glob("*.npy"))) == 4
    second = build_yolo_dataset(cfg, img_dir, mode="train")
    assert isinstance(second.load_image(0), np.memmap)
    rng = random.Random(0)
    b = [second.get_sample(i, rng) for i in range(4)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["bboxes"], y["bboxes"])
        assert all(np.array_equal(p, q) for p, q in zip(x["tiles"], y["tiles"]))


def test_loader_length_and_shuffle_match_jax(train_set):
    img_dir, _ = train_set
    jcfg = get_cfg(overrides={"imgsz": IMGSZ})
    jl = JaxDataLoader(jax_build_dataset(jcfg, img_dir, BATCH, {}, mode="train"),
                       batch_size=BATCH, seed=7)
    pl = TrainLoader(build_yolo_dataset(port_get_cfg(overrides={"imgsz": IMGSZ}), img_dir,
                                        mode="train"), batch_size=BATCH, seed=7, workers=0)
    assert len(pl) == len(jl) == 3
    for epoch in range(3):
        assert pl._epoch_indices(epoch) == jl._epoch_indices(epoch)
