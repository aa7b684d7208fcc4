"""The port's train augmentation held against the JAX package's, on the CPU.

Pixels: ``pixels.warp_affine_u8`` / ``warp_perspective_u8`` equal
``cv2.warpAffine`` / ``cv2.warpPerspective`` (border 114) byte for byte on
random images and output sizes, with matrices drawn as
``RandomPerspective._matrix`` draws them, each of scale, translate,
degrees, shear and perspective on and off (output widths not a multiple of
16 take OpenCV's scalar tail); the HSV conversions equal ``cvtColor`` over
the whole colour cube (BGR -> HSV) and every HSV triple (HSV -> BGR); and
``hsv_jitter_u8`` equals ``RandomHSV`` with the same rng.

End to end: ``TrainTransforms`` of the port (labels and recipe on the host,
pixels composed on the CPU) against JAX's at imgsz 160 on PNG files of
mixed shapes, through the 4- and 9-grid mosaic, the plain letterbox path,
degrees, shear, perspective, copy-paste, flips both ways and mixup (with
``np.random.beta`` and the port's ``mixup_ratio`` both fixed to one r):
images byte-equal, ``cls`` and ``bboxes`` (float32) equal exactly, and the
rng in the same state afterwards (JAX's draws, draw for draw).
"""

import math
import random

import cv2
import numpy as np
import pytest
import torch

from test_torch_train_loader import one_thread, write_train_set  # noqa: F401
from xlstm_yolo_tpu.data import augment as jax_aug
from xlstm_yolo_tpu.data.dataset import YOLODataset as JaxYOLODataset
from xlstm_yolo_tpu_torch.data import augment, pixels
from xlstm_yolo_tpu_torch.data.dataset import YOLODataset

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

IMGSZ = 160
GEOMETRY = {
    "scale": dict(scale=0.5, translate=0.0),
    "translate": dict(scale=0.0, translate=0.3),
    "degrees": dict(degrees=30.0, scale=0.0, translate=0.0),
    "shear": dict(shear=8.0, scale=0.0, translate=0.0),
    "perspective": dict(perspective=0.0015, scale=0.0, translate=0.0),
    "all": dict(degrees=20.0, shear=5.0, perspective=0.001, scale=0.5, translate=0.2),
    "none": dict(scale=0.0, translate=0.0),
}


@pytest.mark.parametrize("kind", sorted(GEOMETRY))
def test_warps_equal_opencv(kind):
    rng = np.random.default_rng(sorted(GEOMETRY).index(kind))
    draws = random.Random(11)
    rp = jax_aug.RandomPerspective(**GEOMETRY[kind])
    for case in range(6):
        h, w = draws.randint(40, 260), draws.randint(40, 260)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        M, _, _, _ = rp._matrix(img, draws)
        dsize = (draws.randint(40, 300), draws.randint(40, 300))
        if case == 0:
            dsize = (160, 160)
        t = torch.from_numpy(img)
        if rp.perspective:
            ref = cv2.warpPerspective(img, M, dsize=dsize, borderValue=(114,) * 3)
            got = pixels.warp_perspective_u8(t, M, dsize)
        else:
            ref = cv2.warpAffine(img, M[:2], dsize=dsize, borderValue=(114,) * 3)
            got = pixels.warp_affine_u8(t, M, dsize)
        assert np.array_equal(got.numpy(), ref), (kind, case, dsize)


def test_rotation_matrix_equals_opencv():
    draws = random.Random(2)
    for _ in range(50):
        a, s = draws.uniform(-180, 180), draws.uniform(0.1, 2.0)
        ref = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
        assert np.array_equal(augment.rotation_matrix(a, s), ref + 0.0)


def test_bgr_to_hsv_equals_opencv_on_every_colour():
    v = np.arange(256, dtype=np.uint8)
    cube = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    got = pixels.bgr_to_hsv_u8(torch.from_numpy(cube)).numpy()
    assert np.array_equal(got, cv2.cvtColor(cube, cv2.COLOR_BGR2HSV))


def test_hsv_to_bgr_equals_opencv_on_every_triple():
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(180 * 256, 256, 3)
    got = pixels.hsv_to_bgr_u8(torch.from_numpy(hsv)).numpy()
    assert np.array_equal(got, cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


@pytest.mark.parametrize("gains", [(0.015, 0.7, 0.4), (0.5, 0.9, 0.9), (0.0, 0.0, 0.0)])
def test_hsv_jitter_equals_random_hsv(gains):
    rng = np.random.default_rng(4)
    for seed in range(3):
        img = rng.integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
        r_jax, r_port = random.Random(seed), random.Random(seed)
        ref = jax_aug.RandomHSV(*gains)(img, r_jax)
        luts = augment.RandomHSV(*gains)(r_port)
        assert r_jax.getstate() == r_port.getstate()
        if luts is None:
            assert ref is img
            continue
        got = pixels.hsv_jitter_u8(torch.from_numpy(img)[None], torch.from_numpy(luts)[None])
        assert np.array_equal(got[0].numpy(), ref)


def test_mixup_blend_equals_numpy():
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(2))
    for r in (0.3, 0.5, 0.61803, 0.999):
        ref = (a * r + b * (1 - r)).astype(np.uint8)
        got = pixels.mixup_u8(torch.from_numpy(a), torch.from_numpy(b), r).numpy()
        assert np.array_equal(got, ref)


PIPELINES = {
    "default": {},
    "mosaic9": dict(mosaic9=True),
    "letterbox": dict(mosaic=0.0),
    "geometry": dict(degrees=15.0, shear=4.0, translate=0.2, scale=0.6),
    "perspective": dict(perspective=0.0008, degrees=5.0),
    "perspective_plain": dict(perspective=0.0008, mosaic=0.0),
    "copy_paste_flips": dict(copy_paste=0.9, flipud=0.5, fliplr=0.5, scale=0.2),
    "mixup": dict(mixup=0.7, mosaic=0.8),
    "no_hsv_no_flip": dict(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, fliplr=0.0),
}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("augset")
    write_train_set(root, 8, seed=9)
    img_dir = str(root / "images" / "train")
    return JaxYOLODataset(img_dir, imgsz=IMGSZ), YOLODataset(img_dir, imgsz=IMGSZ)


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_train_transforms_match_jax(datasets, name, monkeypatch):
    jds, pds = datasets
    kw = PIPELINES[name]
    r_mix = 0.4375
    monkeypatch.setattr(np.random, "beta", lambda a, b: r_mix)
    monkeypatch.setattr(augment, "mixup_ratio", lambda rng: r_mix)
    jt = jax_aug.TrainTransforms(dataset=jds, imgsz=IMGSZ, **kw)
    pt = augment.TrainTransforms(dataset=pds, imgsz=IMGSZ, **kw)
    recipes, tiles, refs, n_boxes, pasted = [], [], [], 0, 0
    for k in range(2 * len(pds)):
        r_jax, r_port = random.Random(100 + k), random.Random(100 + k)
        ref = jt(k % len(pds), r_jax)
        recipe, ims, got = pt(k % len(pds), r_port)
        assert r_jax.getstate() == r_port.getstate(), k
        np.testing.assert_array_equal(got["cls"], ref["cls"])
        assert got["bboxes"].dtype == ref["bboxes"].dtype == np.float32
        np.testing.assert_array_equal(got["bboxes"], ref["bboxes"])
        recipes.append(recipe)
        tiles.append(ims)
        refs.append(ref["img"])
        n_boxes += len(ref["cls"])
        pasted += len(recipe["paste"])
    got = pixels.compose_batch(recipes, tiles, "cpu").flip(-1).numpy()  # RGB -> BGR
    for k, ref in enumerate(refs):
        assert np.array_equal(got[k], ref), (name, k, int((got[k] != ref).sum()))
    assert n_boxes > 0
    if name == "copy_paste_flips":
        assert pasted > 0
    if name == "mixup":
        assert any(rc["mixup"] is not None for rc in recipes)
    if "mosaic9" in kw:
        assert all(rc["canvas"]["crop"] is not None for rc in recipes)


def test_mixup_ratio_repeats_and_leaves_rng():
    rng = random.Random(3)
    state = rng.getstate()
    r1 = augment.mixup_ratio(rng)
    assert rng.getstate() == state and r1 == augment.mixup_ratio(random.Random(3))
    assert 0.0 < r1 < 1.0 and not math.isclose(r1, augment.mixup_ratio(random.Random(4)))
