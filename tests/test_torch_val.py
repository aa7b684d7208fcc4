"""The port's validation path held against the JAX package's, on the CPU.

1. The val batch: PNG files of the shapes that exercise the val
   pre-resize (its ceil both ways, 2x downscales, where OpenCV's linear
   resize takes its area path, and upscales), with duplicate, invalid,
   polygon, empty and missing label files and 130 boxes in one image
   (truncated at ``max_targets`` = 128, as JAX does).  The port's
   collated batch, letterboxed on the CPU, equals JAX ``YOLODataset`` +
   ``collate`` field for field: image bytes, classes and mask exactly,
   boxes to 1e-4 px, original shapes and ``ratio_pad``.
2. Both validators with the forward replaced by the same stored (B, 300, 6)
   detections (class ids past ``nc`` among them), 6 images at batch 4:
   ``results_dict`` to 1e-12, the COCO json rows and the confusion matrix
   equal.
3. End to end: ``vil-det-tiny`` at 160 px, float32, JAX weights carried
   into the port, validated on a set labelled from JAX's own detections
   (its top 20 an image), with ``max_det`` 20 so that each image's
   unlabelled detections drop out.  The random box regressions are made
   short first (``short_boxes``): at the seed's weights they span 10-30
   strides, so most boxes clip to the whole image, where two detections of
   one class give the same label row, which the label dedup merges, and the
   second becomes a false positive in both packages (0.898 in both).  Both
   must score mAP50-95 >= 0.9 and differ by at most 0.02 (measured: JAX 0.9654, the port 0.9654;
   mAP50 0.9697 in both).
4. ``YOLO('x.pt')``: a saved state dict loads strictly into
   ``vil-det-192``; JAX's ignored keys are dropped, any other missing or
   extra key raises naming it, and a pickled module is refused..
"""

import json
import pickle
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_model import jax_detector
from xlstm_yolo_tpu.cfg import get_cfg
from xlstm_yolo_tpu.data.dataset import YOLODataset as JaxYOLODataset
from xlstm_yolo_tpu.engine import validator as jax_validator
from xlstm_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset
from xlstm_yolo_tpu_torch.data.imread import imwrite_png
from xlstm_yolo_tpu_torch.engine import validator
from xlstm_yolo_tpu_torch.engine.model import YOLO
from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

ROOT = Path(__file__).resolve().parents[1]
# (960, 1280) and (1080, 1920) downscale 2x and 3x, (333, 500) and (97, 211)
# upscale with a ceil that rounding would miss
SHAPES = [(480, 640), (375, 500), (333, 500), (1080, 1920), (150, 200), (640, 640), (97, 211),
          (960, 1280)]


def write_set(root: Path, shapes, labels: dict, names, seed: int, name="data.yaml") -> Path:
    """PNG images of ``shapes`` under root/images/val, ``labels[j]`` (a list
    of rows, or None for no file) under root/labels/val; the dataset YAML."""
    rng = np.random.default_rng(seed)
    (root / "images" / "val").mkdir(parents=True, exist_ok=True)
    (root / "labels" / "val").mkdir(parents=True, exist_ok=True)
    for j, (h, w) in enumerate(shapes):
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1)
        im = (base + rng.integers(-40, 40, (h, w, 3))).clip(0, 255).astype(np.uint8)
        imwrite_png(root / "images" / "val" / f"im{j:02d}.png", im, level=1)
        if labels.get(j) is not None:
            (root / "labels" / "val" / f"im{j:02d}.txt").write_text("\n".join(labels[j]) + "\n")
    path = root / name
    path.write_text(yaml.safe_dump({"path": str(root), "val": "images/val", "names": names}))
    return path


def fixture_labels(rng):
    many = [f"{j % 3} {x:.6f} {y:.6f} 0.05 0.04" for j, (x, y) in
            enumerate(rng.uniform(0.05, 0.95, (130, 2)))]
    return {
        0: ["0 0.5 0.5 0.2 0.3", "1 0.25 0.3 0.1 0.1", "0 0.5 0.5 0.2 0.3",  # exact duplicate
            "2 0.7 0.6 0.3 0.2", "1 0.25 0.3 0.1 0.1", "0 0.5 0.5 0.2 0.30001"],
        1: ["0 0.5 0.5 0 0.3", "1 1.2 0.5 0.1 0.1", "1 0.5 -0.1 0.1 0.1", "2 0.5 0.5 0.1",
            "", "1 0.4 0.4 0.2 0.2", "0 0.5 0.5 0.1 1.00009"],
        2: [],  # empty file
        # 3: no label file
        4: many,
        5: ["1 0.1 0.1 0.3 0.1 0.2 0.4", "0 0.6 0.6 0.2 0.2 0.7"],  # polygon, 6 values
        6: ["2 0.5 0.5 0.4 0.6", "0 0.9 0.1 0.1 0.1"],
        7: ["1 0.3 0.7 0.25 0.15", "2 0.75 0.25 0.2 0.3"],
    }


def test_val_batch_equals_jax(tmp_path):
    data = write_set(tmp_path, SHAPES, fixture_labels(np.random.default_rng(1)),
                     ["a", "b", "c"], seed=2)
    split = check_det_dataset(str(data))["val"]
    port = YOLODataset(split, imgsz=640)
    batch = port.collate([port.get_sample(i) for i in range(len(port))])
    img = port.images(batch, "cpu").numpy()
    jds = JaxYOLODataset(split, imgsz=640)
    ref = jds.collate([jds.get_sample(i, random.Random(0)) for i in range(len(jds))])
    assert img.shape == ref["img"].shape == (len(SHAPES), 640, 640, 3)
    for j in range(len(SHAPES)):  # image by image, to name the one that differs
        np.testing.assert_array_equal(img[j], ref["img"][j], err_msg=f"image {SHAPES[j]}")
    np.testing.assert_array_equal(batch["cls"], ref["cls"])
    np.testing.assert_array_equal(batch["mask"], ref["mask"])
    np.testing.assert_allclose(batch["bboxes"], ref["bboxes"], atol=1e-4, rtol=0)
    assert batch["orig_shape"] == ref["orig_shape"] == SHAPES
    assert batch["ratio_pad"] == ref["ratio_pad"]
    assert batch["im_file"] == ref["im_file"]
    assert batch["mask"].sum(1).tolist() == [4, 2, 0, 0, 128, 2, 2, 2]
    assert batch["resized_shape"][2] == (427, 640)  # ceil(333 * 1.28)


PORT_ONLY_LOADER = r"""
import sys
for blocked in ("jax", "jaxlib", "xlstm_yolo_tpu"):
    sys.modules[blocked] = None
import numpy as np
from xlstm_yolo_tpu_torch.data.build import build_dataloader, build_yolo_dataset
from xlstm_yolo_tpu_torch.data.dataset import check_det_dataset
data = check_det_dataset(sys.argv[1])
ds = build_yolo_dataset({"imgsz": 160}, data["val"])
got = list(build_dataloader(ds, 3, workers=2))
ref = [ds.collate([ds.get_sample(i) for i in range(s, min(s + 3, len(ds)))])
       for s in range(0, len(ds), 3)]
assert [len(b["im0"]) for b in got] == [3, 3, 2]
for g, r in zip(got, ref):
    for k in ("cls", "bboxes", "mask"):
        np.testing.assert_array_equal(g[k], r[k])
    for a, b in zip(g["im0"], r["im0"]):
        np.testing.assert_array_equal(a, b)
    assert g["ratio_pad"] == r["ratio_pad"] and g["im_file"] == r["im_file"]
print("ok")
"""


def test_loader_workers_give_the_in_process_batches(tmp_path):
    """Two worker processes (the port alone, no JAX in the process) give
    the batches the calling process makes, in order, the tail batch short."""
    data = write_set(tmp_path, SHAPES, fixture_labels(np.random.default_rng(1)), ["a", "b", "c"],
                     seed=3)
    proc = subprocess.run([sys.executable, "-c", PORT_ONLY_LOADER, str(data)], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


class StoredJaxModel:
    """Stands in for the flax module: ``apply`` returns the next stored batch."""

    def __init__(self, batches):
        self.batches = iter(batches)

    def apply(self, variables, x):
        return jnp.asarray(next(self.batches)), None


class StoredModel(torch.nn.Module):
    def __init__(self, batches):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))  # the validator reads its device
        self.batches = iter(batches)

    def forward(self, x):
        return torch.from_numpy(next(self.batches)), None


def stored_detections(dataset, bs, imgsz, nc, rng):
    """(bs, 300, 6) score-sorted detections a batch: jittered copies of each
    image's boxes (near-tied IoUs among them) and strays, classes up to
    nc + 1; the tail batch padded to bs, as the validators pad it."""
    batches, rows = [], []
    for i in range(len(dataset)):
        s = dataset.get_sample(i)
        gt, cls = s["bboxes"][s["mask"]], s["cls"][s["mask"]]
        k = min(len(gt) * 3, 120)
        src = gt[rng.integers(0, len(gt), k)] if len(gt) else np.zeros((0, 4), np.float32)
        near = src + rng.choice([0.0, 0.5, 1.5, 4.0], (k, 1)) * rng.normal(size=(k, 4))
        xy = rng.uniform(0, imgsz, (300 - k, 2))
        stray = np.concatenate([xy, xy + rng.uniform(2, imgsz / 3, (300 - k, 2))], 1)
        c = np.concatenate([cls[rng.integers(0, len(cls), k)] if len(cls) else np.zeros(0),
                            rng.integers(0, nc + 2, 300 - k)])
        conf = np.sort(rng.choice(np.r_[np.linspace(0.0005, 0.99, 40), 0.25], 300))[::-1]
        det = np.concatenate([np.concatenate([near, stray]), conf[:, None], c[:, None]], 1)
        rows.append(det[np.argsort(-det[:, 4], kind="stable")].astype(np.float32))
    for s in range(0, len(rows), bs):
        b = rows[s:s + bs]
        batches.append(np.stack(b + [np.zeros((300, 6), np.float32)] * (bs - len(b))))
    return batches


def test_validators_agree_on_stored_detections(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    shapes = [(120, 160), (97, 211), (160, 160), (200, 150), (75, 100), (333, 500)]
    labels = {j: [f"{rng.integers(0, 3)} {x:.5f} {y:.5f} {w:.5f} {h:.5f}"
                  for x, y, w, h in np.c_[rng.uniform(0.2, 0.8, (5, 2)),
                                          rng.uniform(0.05, 0.3, (5, 2))]]
              for j in range(5)}  # the last image has no labels
    data = write_set(tmp_path / "set", shapes, labels, ["a", "b", "c"], seed=5,
                     name="coco-like.yaml")  # "coco" in the name: COCO category ids
    info = check_det_dataset(str(data))
    batches = stored_detections(YOLODataset(info["val"], imgsz=160), 4, 160, 3, rng)

    monkeypatch.setattr(jax, "jit", lambda f: f)  # the stored forward needs no compile
    cfg = get_cfg(overrides={"imgsz": 160, "batch": 4, "workers": 2, "data": str(data),
                             "save_json": True, "plots": True})
    ref_v = jax_validator.DetectionValidator(cfg, data=str(data), save_dir=tmp_path / "jax")
    ref = ref_v({"model": StoredJaxModel(batches), "variables": {}}, batch_size=4)
    port_v = validator.DetectionValidator({"imgsz": 160, "batch": 4, "workers": 0,
                                           "data": str(data), "save_json": True, "plots": True,
                                           "save_dir": tmp_path / "port"})
    got = port_v(StoredModel(batches))
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-12, (k, got[k], ref[k])
    assert 0.05 < ref["metrics/mAP50-95(B)"] < 0.95  # neither trivial nor perfect
    assert port_v.seen == ref_v.seen == 6
    assert port_v.jdict == ref_v.jdict and port_v.jdict
    assert {r["category_id"] for r in port_v.jdict} <= {1, 2, 3}
    assert json.loads((tmp_path / "port" / "predictions.json").read_text()) == port_v.jdict
    np.testing.assert_array_equal(port_v.confusion_matrix.matrix, ref_v.confusion_matrix.matrix)
    assert set(port_v.speed) == {"preprocess", "inference", "postprocess", "metrics"}


def short_boxes(variables):
    """The one-to-one box towers' last conv: kernel x 0.1, bias a ramp of -1
    a DFL bin, so each side's distance is ~0.6 bins (a stride or less)."""
    params = variables["params"]["model_22"]
    for name, conv in params.items():
        if name.startswith("cv2_o2o_") and name.endswith("_2"):
            conv["kernel"] = conv["kernel"] * np.float32(0.1)
            conv["bias"] = np.tile(-np.arange(16, dtype=np.float32), 4)
    return variables


def self_labels(jdict, shapes, top: int):
    """Each image's first ``top`` COCO rows as YOLO label rows."""
    out = {}
    for j, (h, w) in enumerate(shapes):
        rows = [r for r in jdict if r["image_id"] == f"im{j:02d}"][:top]
        out[j] = [f"{r['category_id']} {(r['bbox'][0] + r['bbox'][2] / 2) / w:.6f} "
                  f"{(r['bbox'][1] + r['bbox'][3] / 2) / h:.6f} {r['bbox'][2] / w:.6f} "
                  f"{r['bbox'][3] / h:.6f}" for r in rows]
    return out


def test_tiny_self_labelled_map_matches_jax(tmp_path):
    shapes = [(120, 160), (97, 211), (160, 160), (200, 150), (75, 100), (333, 500), (64, 48),
              (150, 200)]
    names = [f"c{i}" for i in range(80)]
    data = write_set(tmp_path / "set", shapes, {}, names, seed=6)
    _, jm, variables, _ = jax_detector("vil-det-tiny.yaml", batch=1)
    variables = short_boxes(variables)
    bundle = {"model": jm, "variables": jax.tree.map(jnp.asarray, variables)}
    overrides = {"imgsz": 160, "batch": 4, "workers": 2, "data": str(data), "plots": False}
    first = jax_validator.DetectionValidator(get_cfg(overrides={**overrides, "save_json": True}),
                                             data=str(data), save_dir=tmp_path / "pass1")
    first(bundle, batch_size=4, verbose=False)
    labels = self_labels(first.jdict, shapes, top=20)
    assert sum(map(len, labels.values())) == 20 * len(shapes)
    for j, rows in labels.items():
        (tmp_path / "set" / "labels" / "val" / f"im{j:02d}.txt").write_text("\n".join(rows))
    # JAX's label cache is keyed by the image paths, not the labels: drop the
    # one pass 1 wrote (the port keeps none)
    for cache in (tmp_path / "set" / "images" / "val").glob(".xyt_labels_*.cache.npz"):
        cache.unlink()
    overrides["max_det"] = 20
    ref = jax_validator.DetectionValidator(get_cfg(overrides=overrides), data=str(data),
                                           save_dir=tmp_path / "jax")(bundle, batch_size=4)
    yolo = YOLO("vil-det-tiny.yaml", device="cpu", compute_dtype=torch.float32)
    yolo.model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    got = yolo.val(data=str(data), imgsz=160, batch=4, workers=0, plots=False, max_det=20)
    print("mAP50-95 JAX", ref["metrics/mAP50-95(B)"], "port", got["metrics/mAP50-95(B)"],
          "mAP50 JAX", ref["metrics/mAP50(B)"], "port", got["metrics/mAP50(B)"])
    assert ref["metrics/mAP50-95(B)"] >= 0.9 and got["metrics/mAP50-95(B)"] >= 0.9
    assert abs(got["metrics/mAP50-95(B)"] - ref["metrics/mAP50-95(B)"]) <= 0.02
    assert abs(got["metrics/mAP50(B)"] - ref["metrics/mAP50(B)"]) <= 0.02
    assert yolo.validator.seen == 8


def test_pt_checkpoint_loads_strictly(tmp_path):
    """No forward: the full-width model is only built."""
    yolo = YOLO("vil-det-192.yaml", device="cpu")
    sd = {k: v + 0.5 if v.is_floating_point() else v for k, v in yolo.model.state_dict().items()}
    ignored = {"model.22.dfl.conv.weight": torch.arange(16.0).view(1, 16, 1, 1),
               "model.0.module.bn.num_batches_tracked": torch.tensor(3)}
    torch.save({"ema": {**sd, **ignored}, "model": None}, tmp_path / "ema.pt")
    torch.save(sd, tmp_path / "plain.pt")
    for name in ("ema.pt", "plain.pt"):
        got = YOLO(str(tmp_path / name), device="cpu")
        assert Path(got.model_cfg).name == "vil-det-192.yaml"
        for k, v in got.model.state_dict().items():
            assert torch.equal(v, sd[k]), k
    first = next(iter(sd))
    cases = {"missing": {k: v for k, v in sd.items() if k != first},
             "extra": {**sd, "model.22.unknown.weight": torch.zeros(1)}}
    for case, bad in cases.items():
        torch.save({"model": bad}, tmp_path / f"{case}.pt")
        key = first if case == "missing" else "model.22.unknown.weight"
        with pytest.raises(RuntimeError, match=key.replace(".", r"\.")):
            YOLO(str(tmp_path / f"{case}.pt"), device="cpu")
    torch.save({"model": torch.nn.Linear(2, 2)}, tmp_path / "module.pt")
    with pytest.raises(pickle.UnpicklingError):
        YOLO(str(tmp_path / "module.pt"), device="cpu")
    with pytest.raises(FileNotFoundError):
        YOLO(str(tmp_path / "absent.pt"), device="cpu")
