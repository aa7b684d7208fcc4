"""The task datasets' train samples and the classify augmentation against
the JAX package's, on the CPU.

Segment, pose and OBB sets are written by ``tests/test_instance_augment.py``'s
writers (JPEG triangles with polygon rows; JPEG boxes with 4 keypoints and
a ``flip_idx``) and ``tests/test_torch_task_val.py``'s (PNG boxes labelled
by their corners).  Through each pipeline (the 4- and 9-grid mosaic, the
letterbox path, rotation, shear, perspective, copy-paste, mixup, flips both
ways) the port's ``TrainTransforms`` and JAX's, each with the same
``random.Random``, give equal ``cls``, ``bboxes``, ``segments`` and
``keypoints`` (exactly: the same numpy arithmetic) and leave the rng in
the same state; the port's recipes composed on the CPU are byte-equal to
JAX's OpenCV pixels.  ``get_sample`` then gives equal masks (``fillPoly`` at
imgsz / 4), rotated boxes (``minAreaRect``) and keypoints.  Mixup's ratio
is fixed to one r on both sides (JAX draws it from numpy's global state).

Classify: the port's ``ClassifyAugment`` recipe composed by
``pixels.compose_classify`` is byte-equal to JAX's ``ClassifyAugment`` on
random images of several sizes, a crop of exactly 2x the output size among
them (OpenCV resizes that as INTER_AREA; the port's INTER_LINEAR gives the
same bytes), and ``ClassificationDataset``'s train samples equal JAX's.
"""

import random
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from test_instance_augment import _write_pose_dataset, _write_seg_dataset
from test_torch_task_val import write_obb_dataset
from xlstm_yolo_tpu.data import augment as jax_aug
from xlstm_yolo_tpu.data.dataset import ClassificationDataset as JaxClsDataset
from xlstm_yolo_tpu.data.dataset import YOLODataset as JaxYOLODataset
from xlstm_yolo_tpu_torch.data import augment, pixels
from xlstm_yolo_tpu_torch.data.dataset import ClassificationDataset, YOLODataset

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

IMGSZ = 160
R_MIX = 0.4375
BASE = dict(mosaic=1.0, mixup=0.0, degrees=0.0, translate=0.1, scale=0.5, shear=0.0,
            perspective=0.0, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, fliplr=0.5, flipud=0.0,
            copy_paste=0.0)
PIPELINES = {
    "segment": {"default": {}, "mosaic9": dict(mosaic9=True), "letterbox": dict(mosaic=0.0),
                "geometry": dict(degrees=15.0, shear=4.0, translate=0.2, scale=0.6),
                "perspective": dict(perspective=0.0008, degrees=5.0),
                "copy_paste_flips": dict(copy_paste=0.9, flipud=0.5, scale=0.2),
                "mixup": dict(mixup=0.7, mosaic=0.8)},
    "pose": {"default": {}, "mosaic9": dict(mosaic9=True), "letterbox": dict(mosaic=0.0),
             "geometry_flips": dict(degrees=20.0, shear=4.0, flipud=0.5, copy_paste=0.9)},
    "obb": {"default": {}, "geometry": dict(degrees=30.0, scale=0.3),
            "flips_letterbox": dict(mosaic=0.5, flipud=0.5, copy_paste=0.9)},
}
CASES = [(t, p) for t in PIPELINES for p in PIPELINES[t]]


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("tasktrainaug")
    return {"segment": _write_seg_dataset(root / "seg", n=8), "pose": _write_pose_dataset(
        root / "pose", n=8), "obb": write_obb_dataset(root / "obb", n=8)}


def make_pair(data, task, kw, flip_idx=True):
    """JAX's and the port's train datasets of ``data`` with the hyp ``kw``."""
    root = data.parent
    hyp = SimpleNamespace(**{**BASE, **{k: v for k, v in kw.items() if k != "mosaic9"}})
    extra = {}
    if task == "pose":
        extra = dict(kpt_shape=(4, 3), flip_idx=[1, 0, 3, 2] if flip_idx else None)
    img_dir = str(root / "images" / "train")
    jds = JaxYOLODataset(img_dir, imgsz=IMGSZ, task=task, augment=True, hyp=hyp,
                         max_targets=16, **extra)
    pds = YOLODataset(img_dir, imgsz=IMGSZ, task=task, augment=True, hyp=hyp, max_targets=16,
                      **extra)
    if kw.get("mosaic9"):
        for ds, mod in ((jds, jax_aug), (pds, augment)):
            ds.transforms = mod.TrainTransforms(
                dataset=ds, imgsz=IMGSZ, mosaic9=True, flip_idx=ds.transforms.flip_idx,
                **{k: getattr(ds.transforms, k) for k in BASE})
    return jds, pds


@pytest.mark.parametrize("task,name", CASES)
def test_task_transforms_match_jax(sets, task, name, monkeypatch):
    monkeypatch.setattr(np.random, "beta", lambda a, b: R_MIX)
    monkeypatch.setattr(augment, "mixup_ratio", lambda rng: R_MIX)
    jds, pds = make_pair(sets[task], task, PIPELINES[task][name])
    recipes, tiles, refs, n_inst, pasted = [], [], [], 0, 0
    for k in range(2 * len(pds)):
        r_jax, r_port = random.Random(100 + k), random.Random(100 + k)
        ref = jds.transforms(k % len(pds), r_jax)
        recipe, ims, got = pds.transforms(k % len(pds), r_port)
        assert r_jax.getstate() == r_port.getstate(), k
        for key in ("cls", "bboxes", "segments"):
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{key} {k}")
        if task == "pose":
            np.testing.assert_array_equal(got["keypoints"], ref["keypoints"])
        else:
            assert got["keypoints"] is None and ref["keypoints"] is None
        assert (got["segments"].shape[1] > 0) == (task != "pose")
        recipes.append(recipe)
        tiles.append(ims)
        refs.append(ref["img"])
        n_inst += len(ref["cls"])
        pasted += len(recipe["paste"])
    got = pixels.compose_batch(recipes, tiles, "cpu").flip(-1).numpy()  # RGB -> BGR
    for k, ref in enumerate(refs):
        assert np.array_equal(got[k], ref), (task, name, k, int((got[k] != ref).sum()))
    assert n_inst > 0
    if "copy_paste" in name and task != "pose":
        assert pasted > 0
    if task == "pose":
        assert pasted == 0  # keypoint datasets paste nothing
    if name == "mixup":
        assert any(rc["mixup"] is not None for rc in recipes)


@pytest.mark.parametrize("task", sorted(PIPELINES))
def test_task_train_samples_match_jax(sets, task):
    """get_sample: the padded boxes and the task targets made after the
    transforms (masks, rotated boxes, keypoints) equal JAX's."""
    jds, pds = make_pair(sets[task], task, dict(degrees=10.0, flipud=0.5))
    key = {"segment": "masks", "pose": "kpts", "obb": "rboxes"}[task]
    filled = 0
    for k in range(2 * len(pds)):
        ref = jds.get_sample(k % len(pds), random.Random(7 + k))
        got = pds.get_sample(k % len(pds), random.Random(7 + k))
        for name in ("cls", "bboxes", "mask", key):
            assert got[name].dtype == ref[name].dtype, name
            np.testing.assert_array_equal(got[name], ref[name], err_msg=f"{name} {k}")
        img = pixels.compose_batch([got["recipe"]], [got["tiles"]], "cpu")[0].numpy()
        assert np.array_equal(img, ref["img"]), (task, k)
        filled += int(np.count_nonzero(got[key]))
    assert filled > 0
    batch = pds.collate([pds.get_sample(i, random.Random(i)) for i in range(3)])
    assert batch[key].shape[0] == 3


def test_pose_without_flip_idx_does_not_flip_left_right(sets):
    jds, pds = make_pair(sets["pose"], "pose", dict(fliplr=0.9), flip_idx=False)
    assert pds.transforms.fliplr == jds.transforms.fliplr == 0.0
    _, pds2 = make_pair(sets["pose"], "pose", dict(fliplr=0.9))
    assert pds2.transforms.fliplr == 0.9 and pds2.flip_idx == [1, 0, 3, 2]


# ---------------------------------------------------------------------------
# classify


CLS_CASES = {
    "default": ((200, 150), {}),
    "two_x_crop": ((448, 448), dict(scale=(1.0, 1.0), ratio=(1.0, 1.0))),
    "tall_fallback": ((400, 60), dict(scale=(0.9, 1.0))),
    "flips_erase": ((96, 300), dict(vflip=0.5, erasing=0.9)),
    "no_hsv": ((224, 224), dict(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, erasing=0.5)),
}


@pytest.mark.parametrize("name", sorted(CLS_CASES))
def test_classify_augment_matches_jax(name):
    (h, w), kw = CLS_CASES[name]
    rng = np.random.default_rng(11)
    jt, pt = jax_aug.ClassifyAugment(size=224, **kw), augment.ClassifyAugment(size=224, **kw)
    recipes, crops, refs = [], [], []
    for k in range(6):
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        r_jax, r_port = random.Random(50 + k), random.Random(50 + k)
        refs.append(jt(im, r_jax))
        rc = pt((h, w), r_port)
        assert r_jax.getstate() == r_port.getstate()
        top, left, ch, cw = rc["crop"]
        recipes.append(rc)
        crops.append(im[top:top + ch, left:left + cw])
    got = pixels.compose_classify(recipes, crops, "cpu").flip(-1).numpy()  # RGB -> BGR
    for k, ref in enumerate(refs):
        assert np.array_equal(got[k], ref), (name, k, int((got[k] != ref).sum()))
    if name == "two_x_crop":  # OpenCV takes its INTER_AREA path for exactly 2x down
        assert all(rc["crop"] == (0, 0, 448, 448) for rc in recipes)
        one = cv2.resize(crops[0], (224, 224), interpolation=cv2.INTER_LINEAR)
        assert np.array_equal(one, augment.resize_linear_u8(torch.from_numpy(crops[0]), 224,
                                                            224).numpy())
    if "erasing" in kw and kw["erasing"] > 0.5:
        assert any(rc["erase"] is not None for rc in recipes)


def test_classification_dataset_train_samples_match_jax(tmp_path):
    from test_torch_task_val import write_cls_dataset

    root = write_cls_dataset(tmp_path) / "val"
    hyp = SimpleNamespace(scale=0.5, fliplr=0.5, flipud=0.2, hsv_h=0.015, hsv_s=0.7,
                          hsv_v=0.4, erasing=0.4, crop_fraction=1.0)
    jds = JaxClsDataset(str(root), imgsz=64, augment=True, hyp=hyp)
    pds = ClassificationDataset(str(root), imgsz=64, augment=True, hyp=hyp)
    assert pds.names == jds.names and len(pds) == len(jds)
    samples = [pds.get_sample(i, random.Random(i)) for i in range(len(pds))]
    batch = pds.collate(samples)
    got = pds.images(batch, "cpu").numpy()
    for i in range(len(pds)):
        ref = jds.get_sample(i, random.Random(i))
        assert ref["cls"] == batch["cls"][i] and ref["im_file"] == batch["im_file"][i]
        assert np.array_equal(got[i], ref["img"]), i
