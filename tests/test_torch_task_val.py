"""The task validators, predictors and the task export held against JAX's.

1. The four validators with oracle models (ports of ``_SegOracle`` and
   ``_PoseOracle`` of ``tests/test_seg_pose_e2e.py``, and an OBB and a
   classify oracle) on datasets written by ``tests/test_instance_augment.py``'s
   writers (and an OBB set of boxes and a class-folder set written here):
   the metrics dicts equal JAX's validators' with the same oracles.  The
   oracles read the pixels, so the two packages' val pipelines (decode,
   letterbox, labels, masks, keypoints, rotated boxes, NMS, matching, AP)
   meet in one number each.
2. Each task predictor's ``Results`` against JAX's predictor on the tiny
   task models (float32, the same weights, conf 0, 8 detections a image):
   boxes to 1e-3 px, scores to 1e-5, keypoints to 1e-3 px, oriented boxes
   to 1e-3, probabilities to 1e-6; masks on at least 99.9% of their pixels
   (float32 sums in another order can move a pixel's interpolated value
   across the 0.5 threshold).
3. The ``torch_int8`` export of ``vil-det-tiny-seg`` dequantized bit-equal
   to JAX's ``dequantize_tree(quantize_tree(params))`` carried across
   (Proto's transposed conv per output channel, flax's last axis, torch's
   axis 1), its sidecar's task, ``AutoBackend``'s predictor and its unfused
   model (JAX's backend cannot fold the Segment head either).
"""

import random
from pathlib import Path
from types import SimpleNamespace

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_instance_augment import _write_pose_dataset, _write_seg_dataset
from test_seg_pose_e2e import _PoseOracle, _SegOracle, _val_args
from test_torch_model import CFG
from test_torch_task_heads import jax_shapes, port_to_jax
from xlstm_yolo_tpu.cfg import get_cfg
from xlstm_yolo_tpu.models.yolo.classify.predict import ClassificationPredictor as JCls
from xlstm_yolo_tpu.models.yolo.classify.val import ClassificationValidator as JClsVal
from xlstm_yolo_tpu.models.yolo.obb.predict import OBBPredictor as JObb
from xlstm_yolo_tpu.models.yolo.obb.val import OBBValidator as JObbVal
from xlstm_yolo_tpu.models.yolo.pose.predict import PosePredictor as JPose
from xlstm_yolo_tpu.models.yolo.pose.val import PoseValidator as JPoseVal
from xlstm_yolo_tpu.models.yolo.segment.predict import SegmentationPredictor as JSeg
from xlstm_yolo_tpu.models.yolo.segment.val import SegmentationValidator as JSegVal
from xlstm_yolo_tpu.utils.quantize import dequantize_tree, quantize_tree
from xlstm_yolo_tpu_torch.engine.model import YOLO
from xlstm_yolo_tpu_torch.models.yolo.classify.val import ClassificationValidator
from xlstm_yolo_tpu_torch.models.yolo.model import task_map
from xlstm_yolo_tpu_torch.models.yolo.obb.val import OBBValidator
from xlstm_yolo_tpu_torch.models.yolo.pose.val import PoseValidator
from xlstm_yolo_tpu_torch.models.yolo.segment.val import SegmentationValidator
from xlstm_yolo_tpu_torch.nn.autobackend import AutoBackend
from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict
from xlstm_yolo_tpu_torch.utils.quantize import channel_axes, dequantize_state_dict

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

VAL_KEYS = dict(imgsz=160, batch=2, workers=0, max_targets=16, conf=0.25, iou=0.7, max_det=8,
                plots=False)


def mask_to_box(mask: torch.Tensor) -> torch.Tensor:
    """binary (H, W) -> xyxy of the true region (0s if empty): ``_mask_to_box``."""
    H, W = mask.shape
    xs, ys = torch.arange(W, dtype=torch.float32), torch.arange(H, dtype=torch.float32)
    big = torch.tensor(1e9)
    any_x, any_y = mask.any(0), mask.any(1)
    box = torch.stack([torch.where(any_x, xs, big).min(), torch.where(any_y, ys, big).min(),
                       torch.where(any_x, xs, -big).max() + 1,
                       torch.where(any_y, ys, -big).max() + 1])
    return box if bool(mask.any()) else torch.zeros(4)


class _Oracle(torch.nn.Module):
    """A pixel oracle's rows: one confident detection of the colour blob."""

    def __init__(self):
        super().__init__()
        self.p = torch.nn.Parameter(torch.zeros(1))  # the validators read its device

    def boxes(self, blob):
        B = blob.shape[0]
        boxes = torch.stack([mask_to_box(blob[b]) for b in range(B)])
        conf = blob.reshape(B, -1).any(-1).float() * 0.9
        return boxes, conf, torch.cat([(boxes[:, :2] + boxes[:, 2:]) / 2,
                                       boxes[:, 2:] - boxes[:, :2]], -1)


class SegOracle(_Oracle):
    """``_SegOracle``: the red blob's box and a prototype equal to the blob."""

    def forward(self, x):
        red = (x[..., 0] > 0.6) & (x[..., 1] < 0.4)
        _, conf, xywh = self.boxes(red)
        y = torch.zeros(x.shape[0], 4, 6)
        y[:, 0, :4], y[:, 0, 4], y[:, 0, 5] = xywh, conf, 10.0
        proto = torch.where(red, 10.0, -10.0)[..., None][:, ::4, ::4]
        return y, {"proto": proto}


class PoseOracle(_Oracle):
    """``_PoseOracle``: the blue box and its 4 corners as keypoints."""

    def forward(self, x):
        blue = (x[..., 2] > 0.6) & (x[..., 1] < 0.4)
        boxes, conf, xywh = self.boxes(blue)
        x1, y1, x2, y2 = boxes.unbind(-1)
        one = torch.ones_like(x1)
        kpts = torch.stack([torch.stack(p, -1) for p in
                            ((x1, y1, one), (x2, y1, one), (x1, y2, one), (x2, y2, one))], 1)
        y = torch.zeros(x.shape[0], 4, 17)
        y[:, 0, :4], y[:, 0, 4], y[:, 0, 5:] = xywh, conf, kpts.reshape(-1, 12)
        return y, {}


def jax_obb_oracle_apply(variables, x):
    """The OBB oracle in jnp: the green box, its angle pi/2 on odd images
    (sides swapped: the same box)."""
    B = x.shape[0]
    from test_seg_pose_e2e import _mask_to_box

    green = (x[..., 1] > 0.6) & (x[..., 0] < 0.4)
    boxes = jnp.stack([_mask_to_box(green[b]) for b in range(B)])
    conf = green.reshape(B, -1).any(-1).astype(jnp.float32) * 0.9
    cxy = (boxes[:, :2] + boxes[:, 2:]) / 2
    wh = boxes[:, 2:] - boxes[:, :2]
    odd = (jnp.arange(B) % 2 == 1)[:, None]
    wh = jnp.where(odd, wh[:, ::-1], wh)
    ang = jnp.where(odd[:, 0], jnp.pi / 2, 0.0)
    y = jnp.zeros((B, 4, 4 + 1 + 1), jnp.float32)
    y = y.at[:, 0, :4].set(jnp.concatenate([cxy, wh], -1)).at[:, 0, 4].set(conf)
    return y.at[:, 0, 5].set(ang), {}


class ObbOracle(_Oracle):
    def forward(self, x):
        green = (x[..., 1] > 0.6) & (x[..., 0] < 0.4)
        _, conf, xywh = self.boxes(green)
        odd = (torch.arange(x.shape[0]) % 2 == 1)[:, None]
        xywh = torch.cat([xywh[:, :2], torch.where(odd, xywh[:, 2:].flip(-1), xywh[:, 2:])], -1)
        y = torch.zeros(x.shape[0], 4, 6)
        y[:, 0, :4], y[:, 0, 4] = xywh, conf
        y[:, 0, 5] = torch.where(odd[:, 0], torch.pi / 2, 0.0)
        return y, {}


def class_logits(mean_bgr):
    """The classify oracle: the mean colour's B, G and R as the logits of the
    classes blue, green and red."""
    return mean_bgr * 8.0


class ClsOracle(_Oracle):
    def forward(self, x):
        logits = class_logits(x.mean(dim=(1, 2)).flip(-1))
        return torch.softmax(logits, -1), logits


def write_obb_dataset(root: Path, n: int = 6, size: int = 160) -> Path:
    """Green boxes on grey, labelled by their 4 corners (the OBB row)."""
    (root / "images" / "train").mkdir(parents=True, exist_ok=True)
    (root / "labels" / "train").mkdir(parents=True, exist_ok=True)
    rng = random.Random(2)
    for i in range(n):
        img = np.full((size + 20 * (i % 2), size, 3), 70, np.uint8)
        h, w = img.shape[:2]
        bw, bh = rng.randint(20, 60), rng.randint(20, 60)
        x, y = rng.randint(5, w - 5 - bw), rng.randint(5, h - 5 - bh)
        cv2.rectangle(img, (x, y), (x + bw - 1, y + bh - 1), (0, 255, 0), -1)
        pts = [(x, y), (x + bw, y), (x + bw, y + bh), (x, y + bh)]
        row = "0 " + " ".join(f"{px / w:.5f} {py / h:.5f}" for px, py in pts)
        cv2.imwrite(str(root / "images" / "train" / f"{i}.png"), img)
        (root / "labels" / "train" / f"{i}.txt").write_text(row)
    (root / "data.yaml").write_text(yaml.safe_dump({
        "path": str(root), "train": "images/train", "val": "images/train",
        "names": {0: "box"}, "nc": 1}))
    return root / "data.yaml"


def write_cls_dataset(root: Path) -> Path:
    """val/<class>/*.png: red, green and blue images, and one wrongly filed."""
    rng = np.random.default_rng(0)
    for c, name in enumerate(("blue", "green", "red")):  # BGR files
        d = root / "val" / name
        d.mkdir(parents=True)
        for j in range(3):
            h, w = int(rng.integers(120, 220)), int(rng.integers(120, 220))
            im = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
            im[..., (c + (j == 2)) % 3] += 150  # the third of each class looks like the next
            cv2.imwrite(str(d / f"{j}.png"), im)
    return root


def jax_val(cls, data, task, oracle, **kw):
    args = _val_args(data, task, **kw)
    v = cls(args, data=str(data), save_dir=Path(data).parent / "jv")
    return v(dict(model=oracle, variables={}), batch_size=2)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("taskval")
    return SimpleNamespace(seg=_write_seg_dataset(root / "seg", max_inst=1),
                           seg2=_write_seg_dataset(root / "seg2", max_inst=2),
                           pose=_write_pose_dataset(root / "pose"),
                           obb=write_obb_dataset(root / "obb"),
                           cls=write_cls_dataset(root / "cls"))


@pytest.mark.parametrize("which", ["seg", "seg2"])
def test_segmentation_validator_matches_jax(sets, which):
    data = getattr(sets, which)
    want = jax_val(JSegVal, data, "segment", _SegOracle())
    v = SegmentationValidator({"data": str(data), **VAL_KEYS})
    got = v(SegOracle())
    assert got == want
    assert got["metrics/mAP50(M)"] > 0.5 and v.seen == 6


def test_pose_validator_matches_jax(sets):
    want = jax_val(JPoseVal, sets.pose, "pose", _PoseOracle())
    v = PoseValidator({"data": str(sets.pose), **VAL_KEYS})
    assert v.kpt_shape == (4, 3)
    got = v(PoseOracle())
    assert got == want and got["metrics/mAP50(P)"] > 0.9


def test_obb_validator_matches_jax(sets):
    want = jax_val(JObbVal, sets.obb, "obb", SimpleNamespace(apply=jax_obb_oracle_apply))
    got = OBBValidator({"data": str(sets.obb), **VAL_KEYS})(ObbOracle())
    assert got == want and got["metrics/mAP50(B)"] > 0.9


def test_classification_validator_matches_jax(sets):
    class JaxClsOracle:
        def apply(self, variables, x):
            logits = class_logits(x.mean(axis=(1, 2))[..., ::-1])
            return jax.nn.softmax(logits, -1), logits

    args = get_cfg(overrides={"task": "classify", "imgsz": 64, "batch": 2, "workers": 2})
    want = JClsVal(args, data=str(sets.cls))(dict(model=JaxClsOracle(), variables={}),
                                             batch_size=2)
    got = ClassificationValidator({"data": str(sets.cls), "imgsz": 64, "batch": 2,
                                   "workers": 0})(ClsOracle())
    assert got == want
    assert 0.5 < got["metrics/accuracy_top1"] < 1.0


# 2. predictors ------------------------------------------------------------------------------

PRED = {"segment": ("vil-det-tiny-seg.yaml", JSeg), "pose": ("vil-det-tiny-pose.yaml", JPose),
        "obb": ("vil-det-tiny-obb.yaml", JObb), "classify": ("vil-cls-tiny.yaml", JCls)}


@pytest.mark.parametrize("task", list(PRED))
def test_predictor_results_match_jax(task):
    cfg, jcls = PRED[task]
    rng = np.random.default_rng(7)
    ims = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in ((120, 200), (160, 100))]
    y = YOLO(cfg, task=task, device="cpu", compute_dtype=torch.float32)
    jm, _, shapes = jax_shapes(CFG / cfg, 160, compute_dtype=jnp.float32)
    variables = jax.tree.map(jnp.asarray, port_to_jax(y.model, shapes))
    args = get_cfg(overrides={"task": task, "mode": "predict", "imgsz": 160, "conf": 0.0,
                              "max_det": 8})
    jp = jcls(args, {"model": jm, "variables": variables}, y.names)
    jp._native_letterbox_batch = None  # JAX's LetterBox path, which the port equals
    want = jp(ims)
    got = y.predict(ims, conf=0.0, max_det=8)
    for r, w in zip(got, want):
        if task == "classify":
            np.testing.assert_allclose(r.probs.data, w.probs.data, atol=1e-6)
            assert r.probs.top5 == w.probs.top5 and r.verbose() == w.verbose()
            continue
        if task == "obb":
            np.testing.assert_allclose(r.obb.data, w.obb.data, atol=1e-3)
            np.testing.assert_allclose(r.obb.xyxyxyxy, w.obb.xyxyxyxy, atol=2e-3)
            continue
        np.testing.assert_allclose(r.boxes.data[:, :4], w.boxes.data[:, :4], atol=1e-3)
        np.testing.assert_allclose(r.boxes.data[:, 4:], w.boxes.data[:, 4:], atol=1e-5)
        assert r.summary() == w.summary() or len(r) == len(w) == 8
        assert r.verbose() == w.verbose()
        if task == "pose":
            np.testing.assert_allclose(r.keypoints.data, w.keypoints.data, atol=1e-3)
        else:
            assert r.masks.data.shape == w.masks.data.shape
            differ = (r.masks.data != w.masks.data).mean()
            assert differ < 1e-3, differ
    assert len(got) == 2


def test_task_map_mirrors_jax():
    from xlstm_yolo_tpu.models.yolo.model import task_map as jax_map

    assert set(task_map) == set(jax_map)
    for task, entry in task_map.items():
        assert set(entry) == set(jax_map[task]), task
        for kind, cls in entry.items():
            assert cls.__name__ == jax_map[task][kind].__name__, (task, kind)


@pytest.mark.parametrize("task", ["segment", "pose", "obb", "classify"])
def test_facade_predicts_and_validates_every_task(sets, task):
    """``YOLO(..., task=t)`` through ``task_map``: segment and pose validate
    with the detect validator (box metrics, after NMS of the anchor rows)."""
    y = YOLO(PRED[task][0], task=task, device="cpu", compute_dtype=torch.float32)
    data = {"segment": sets.seg, "pose": sets.pose, "obb": sets.obb, "classify": sets.cls}[task]
    kw = dict(VAL_KEYS, imgsz=64 if task == "classify" else 160)
    res = y.val(data=str(data), **{k: v for k, v in kw.items() if k != "plots"})
    want = {"classify": ClassificationValidator, "obb": OBBValidator}.get(task)
    assert type(y.validator).__name__ == (want.__name__ if want else "DetectionValidator")
    assert y.validator.seen == (9 if task == "classify" else 6) and "fitness" in res
    r = y.predict(np.zeros((90, 120, 3), np.uint8), conf=0.0, max_det=2)[0]
    assert r.orig_img.shape == (90, 120, 3)
    assert (r.probs if task == "classify" else r.obb if task == "obb" else r.boxes) is not None


@pytest.mark.parametrize("task", ["segment", "pose", "obb", "classify"])
def test_facade_trains_detect_only(sets, tmp_path, task):
    """Once a refusal of every task but detect, now ``YOLO(..., task=t).train``
    of each task: one epoch of the tiny task model on the CPU (classify on a
    train/ and val/ copy of its folder set), its own validator on the EMA,
    results.csv, the checkpoints, finite losses and the task's own terms."""
    from shutil import copytree

    y = YOLO(PRED[task][0], task=task, device="cpu", compute_dtype=torch.float32)
    data = {"segment": sets.seg2, "pose": sets.pose, "obb": sets.obb}.get(task)
    if task == "classify":
        data = tmp_path / "cls"
        copytree(sets.cls / "val", data / "val")
        copytree(sets.cls / "val", data / "train")
    m = y.train(data=str(data), imgsz=64 if task == "classify" else 160, batch=2, nbs=2,
                epochs=1, workers=0, amp=False, plots=False, project=str(tmp_path), name=task)
    t = y.trainer
    want = {"segment": "SegmentationValidator", "pose": "PoseValidator", "obb": "OBBValidator",
            "classify": "ClassificationValidator"}[task]
    assert type(t.validator).__name__ == want and "fitness" in m
    assert len((t.save_dir / "results.csv").read_text().splitlines()) == 2
    assert (t.wdir / "last_stripped.pt").is_file() and (t.wdir / "best_stripped.pt").is_file()
    assert all(np.isfinite(float(v)) for mt in t.losses for v in mt.values())
    assert t.train_step.terms and all(float(v) > 0 for v in t.train_step.terms.values())


# 3. export ------------------------------------------------------------------------------------

def test_seg_int8_export_round_trip(tmp_path):
    cfg = "vil-det-tiny-seg.yaml"
    y = YOLO(cfg, task="segment", device="cpu", compute_dtype=torch.float32)
    path = y.export("torch_int8", out_dir=tmp_path)
    be = AutoBackend(path, device="cpu", compute_dtype=torch.float32)
    assert (be.format, be.task, be.fused) == ("torch_int8", "segment", False)

    _, _, shapes = jax_shapes(CFG / cfg, 160)
    variables = port_to_jax(y.model, shapes)
    want = jax_variables_to_state_dict(
        {"params": dequantize_tree(quantize_tree(variables["params"])),
         "batch_stats": variables["batch_stats"]})
    got = be.model.state_dict()
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    up = "model.22.proto.upsample.weight"
    assert channel_axes(y.model)[up] == 1
    assert not torch.equal(got[up], y.model.state_dict()[up])  # it was quantized
    assert torch.equal(dequantize_state_dict({up: want[up]})[up], got[up])

    im = np.random.default_rng(1).integers(0, 256, (100, 150, 3), dtype=np.uint8)
    r = be.predictor({"conf": 0.0, "max_det": 3})([im])[0]
    assert len(r) == 3 and r.masks.data.shape == (3, 100, 150)
