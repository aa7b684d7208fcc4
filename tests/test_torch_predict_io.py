"""The port's predict API from files to Results, held against the JAX package.

1. Box ops (numpy and torch) equal JAX's to 1e-6; ``nms`` and both forms
   of ``non_max_suppression`` equal JAX's exactly, ties included.
2. The TTA helpers: ``scale_img`` against JAX's (``jax.image.resize``,
   antialiased) to 1e-5; ``descale_pred``, ``clip_augmented`` and
   ``predict_augment`` (a stand-in model with a non-end2end output, the
   same function in both frameworks) to 1e-5 (and 1e-4 relative for the
   merged output, whose resized inputs are scaled by the stride); an
   end2end model returns its plain forward.
3. ``Results``: strings, JSON and label files equal JAX's on the same
   detections; plot and save raise.
4. The predictor on a directory of two JPEG files and a PNG file
   (``vil-det-tiny`` at 128 px, batch 2 with a tail, float32, the port's
   seed-0 weights carried into JAX, JAX letterboxing with its
   ``LetterBox``): the same paths and images, and detections within ``test_torch_model``'s tiny tolerance
   (``assert_topk_close``).
5. ``AutoBackend``: a YAML; a ``.pt`` with its ``.meta.json`` sidecar
   (model, imgsz, names); the fused state dict equals JAX's
   ``AutoBackend(fuse=True)`` variables to 1e-6, and the fused forward the
   unfused one to 1e-4; other formats raise.
6. ``ThroughputEngine`` on the CPU against JAX's, batch for batch with a
   tail (1e-6), and the predictor's forward through it equals the eager
   forward exactly.

JAX runs one compiled program of the tiny model.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_model import assert_topk_close
from xlstm_yolo_tpu.engine import results as jax_results
from xlstm_yolo_tpu.engine.predictor import BasePredictor as JaxPredictor
from xlstm_yolo_tpu.engine.serving import ThroughputEngine as JaxEngine
from xlstm_yolo_tpu.nn import tasks as jax_tasks
from xlstm_yolo_tpu.nn.autobackend import AutoBackend as JaxAutoBackend
from xlstm_yolo_tpu.utils import ops as jax_ops
from xlstm_yolo_tpu.utils.torch_convert import convert_torch_state_dict
from xlstm_yolo_tpu_torch.data.imread import encode_png
from xlstm_yolo_tpu_torch.engine.model import COCO_NAMES, YOLO
from xlstm_yolo_tpu_torch.engine.results import Results
from xlstm_yolo_tpu_torch.engine.serving import ThroughputEngine
from xlstm_yolo_tpu_torch.nn import tasks
from xlstm_yolo_tpu_torch.nn.autobackend import AutoBackend
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
from xlstm_yolo_tpu_torch.utils import ops
from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "xlstm_yolo_tpu" / "cfg" / "models" / "vil-det-tiny.yaml"


# 1. box ops and NMS --------------------------------------------------------------------------

def test_box_converters_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 300, (5, 7, 6)).astype(np.float32)
    for make in (lambda a: a, torch.from_numpy):
        for fn, args in ((ops.xywh2xyxy, ()), (ops.xyxy2xywh, ()), (ops.xywhn2xyxy, (640, 480, 3, 5)),
                         (ops.xyxy2xywhn, (640, 480)), (ops.xyxy2xywhn, (200, 150, True, 1e-3)),
                         (ops.clip_boxes, ((200, 150),))):
            xi = x if fn in (ops.xywh2xyxy, ops.xyxy2xywh) else x[..., :4].copy()
            got = np.asarray(fn(make(xi.copy()), *args))
            ref = np.asarray(getattr(jax_ops, fn.__name__)(xi.copy(), *args))
            np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6, err_msg=fn.__name__)
        for ratio_pad, padding in ((None, True), (((0.5, 0.5), (3, 7)), True), (None, False)):
            for fn, cols in ((ops.scale_boxes, 4), (ops.scale_coords, 3)):
                xi = x[..., :cols].copy()
                got = np.asarray(fn((640, 640), make(xi.copy()), (480, 300), ratio_pad, padding))
                ref = getattr(jax_ops, fn.__name__)((640, 640), xi.copy(), (480, 300), ratio_pad,
                                                    padding)
                np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6, err_msg=fn.__name__)
    with ops.Profile() as p:
        pass
    assert p.dt >= 0 and str(p).endswith("s")


def _candidates(rng, b, n, nc):
    xy = rng.uniform(0, 120, (b, n, 2))
    wh = rng.uniform(4, 40, (b, n, 2))
    scores = rng.uniform(0, 1, (b, n, nc))
    scores[:, ::3] = np.round(scores[:, ::3], 1)  # ties
    return np.concatenate([xy, wh, scores], -1).astype(np.float32)


def test_nms_matches_jax_exactly():
    rng = np.random.default_rng(1)
    preds = _candidates(rng, 3, 60, 4)
    boxes = ops.xywh2xyxy(preds[..., :4])
    scores = np.where(preds[..., 4] > 0.3, preds[..., 4], -np.inf).astype(np.float32)
    scores[2] = -np.inf  # an image without candidates
    for b in range(3):
        ref_idx, ref_ok = jax_ops.nms_jax(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.45, 25)
        idx, ok = ops.nms(torch.from_numpy(boxes[b]), torch.from_numpy(scores[b]), 0.45, 25)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    idx, ok = ops.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 25)  # batched
    assert idx.shape == (3, 25) and not ok[2].any() and (idx[2] == -1).all()


def test_non_max_suppression_matches_jax():
    rng = np.random.default_rng(2)
    preds = _candidates(rng, 2, 84, 5)
    for kw in (dict(conf_thres=0.25, iou_thres=0.5, max_det=30, nc=5),
               dict(conf_thres=0.6, iou_thres=0.3, max_det=10, nc=5, return_idx=True)):
        got = ops.non_max_suppression(torch.from_numpy(preds), **kw)
        ref = jax_ops.non_max_suppression(jnp.asarray(preds), **kw)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
    e2e = rng.uniform(0, 1, (2, 40, 6)).astype(np.float32)
    got = ops.non_max_suppression(torch.from_numpy(e2e), 0.5, max_det=25, end2end=True,
                                  return_idx=True)
    ref = jax_ops.non_max_suppression(jnp.asarray(e2e), 0.5, max_det=25, end2end=True,
                                      return_idx=True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# 2. TTA --------------------------------------------------------------------------------------

def _stand_in(x, xp):
    """A decoded (B, A, 4 + 3) xywh head over strides 8/16/32 of an NHWC
    batch: A = 21 * (H / 32)^2, as the detectors' three levels."""
    outs = []
    b, h, w, _ = x.shape
    for s in (8, 16, 32):
        pooled = x.reshape(b, h // s, s, w // s, s, 3).mean(axis=(2, 4)) if xp is jnp else \
            x.reshape(b, h // s, s, w // s, s, 3).mean(dim=(2, 4))
        gy, gx = np.mgrid[0:h // s, 0:w // s]
        ctr = np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32) * s + s / 2
        flat = pooled.reshape(b, -1, 3)
        xy = xp.asarray(ctr)[None] + flat[..., :2] * s
        wh = (flat[..., 1:3] + 0.5) * s
        cat = jnp.concatenate if xp is jnp else torch.cat
        sig = jax.nn.sigmoid if xp is jnp else torch.sigmoid
        outs.append(cat([xy, wh, sig(flat * 4 - 2)], -1))
    return (jnp.concatenate if xp is jnp else torch.cat)(outs, 1), None


def test_tta_helpers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    for ratio in (1.0, 0.83, 0.67):
        got = tasks.scale_img(torch.from_numpy(x), ratio)
        ref = np.asarray(jax_tasks.scale_img(jnp.asarray(x), ratio))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    p = rng.uniform(0, 64, (2, 84, 7)).astype(np.float32)
    for flip in (None, 2, 3):
        np.testing.assert_allclose(tasks.descale_pred(torch.from_numpy(p), flip, 0.83, (64, 48)),
                                   jax_tasks.descale_pred(jnp.asarray(p), flip, 0.83, (64, 48)),
                                   atol=1e-5)
    ys = [p, p[:, :63], p[:, :42]]
    for g, r in zip(tasks.clip_augmented([torch.from_numpy(y) for y in ys]),
                    jax_tasks.clip_augmented([jnp.asarray(y) for y in ys])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # predict_augment on a non-end2end stand-in, the same function in both frameworks
    class StandIn:
        specs = [{"module": "Detect"}]

        def __call__(self, xi):
            return _stand_in(xi, torch)

    port_model = StandIn()
    jax_model = SimpleNamespace(specs=[{"module": "Detect"}],
                                apply=lambda variables, xi: _stand_in(xi, jnp))
    got, _ = tasks.predict_augment(port_model, torch.from_numpy(x))
    ref, _ = jax_tasks.predict_augment(jax_model, None, jnp.asarray(x))
    assert got.shape == ref.shape  # float32 resize sums in another order, times the stride
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)


def test_predict_augment_end2end_is_the_plain_forward():
    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu",
                                     compute_dtype=torch.float32)
    x = torch.rand(1, 128, 128, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y, _ = tasks.predict_augment(model, x)
        torch.testing.assert_close(y, model(x)[0], rtol=0, atol=0)


# 3. Results ----------------------------------------------------------------------------------

def test_results_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    img = np.zeros((120, 200, 3), np.uint8)
    det = np.concatenate([rng.uniform(0, 100, (5, 2)), rng.uniform(100, 190, (5, 2)),
                          rng.uniform(0.2, 0.99, (5, 1)), [[0], [2], [2], [79], [5]]], 1)
    names = dict(COCO_NAMES)
    got = Results(img, "a/b.jpg", names).update(det.astype(np.float32))
    ref = jax_results.Results(img, "a/b.jpg", names).update(det.astype(np.float32))
    assert got.verbose() == ref.verbose() and len(got) == len(ref) == 5
    for norm in (False, True):
        assert got.to_json(norm) == ref.to_json(norm)
    for conf in (False, True):
        a, b = tmp_path / f"port{conf}.txt", tmp_path / f"jax{conf}.txt"
        got.save_txt(a, save_conf=conf), ref.save_txt(b, save_conf=conf)
        assert a.read_text() == b.read_text()
    sub, ref_sub = got[1:3], ref[1:3]
    assert sub.summary() == ref_sub.summary() and sub.cpu() is sub and sub.numpy() is sub
    for attr in ("xyxy", "xywh", "xyxyn", "xywhn", "conf", "cls"):
        np.testing.assert_array_equal(getattr(got.boxes, attr), getattr(ref.boxes, attr))
    track = np.concatenate([det[:, :4], np.arange(5)[:, None], det[:, 4:]], 1)
    t_got = Results(img, "t", names).update(track).boxes
    t_ref = jax_results.Results(img, "t", names).update(track).boxes
    for attr in ("id", "conf", "cls", "xywhn"):
        np.testing.assert_array_equal(getattr(t_got, attr), getattr(t_ref, attr))
    empty = Results(img, "e", names).update(np.zeros((0, 6), np.float32))
    assert empty.verbose() == jax_results.Results(img, "e", names).update(
        np.zeros((0, 6), np.float32)).verbose()
    for call in (got.plot, lambda: got.save("x.jpg")):
        with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
            call()


# 4. predictor --------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried():
    """The port's seed-0 tiny detector and the same weights as JAX variables."""
    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu",
                                     compute_dtype=torch.float32)
    jm, _ = jax_tasks.build_detection_model(TINY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    variables = jax.tree.map(np.asarray, convert_torch_state_dict(shapes, sd, strict=True))
    return SimpleNamespace(model=model, sd=model.state_dict(), jm=jm, variables=variables)


def write_images(root: Path) -> Path:
    rng = np.random.default_rng(5)
    root.mkdir(parents=True, exist_ok=True)
    for j, (h, w) in enumerate([(96, 128), (128, 70), (150, 110)]):
        y, x = np.mgrid[0:h, 0:w]
        im = np.stack([x * 255 // w, y * 255 // h, (x * y) % 256], -1) + rng.integers(-30, 30, (h, w, 3))
        im = im.clip(0, 255).astype(np.uint8)
        if j == 2:
            (root / f"im{j}.png").write_bytes(encode_png(im))
        else:
            cv2.imwrite(str(root / f"im{j}.jpg"), im, [cv2.IMWRITE_JPEG_QUALITY, 85])
    return root


def test_predictor_on_jpeg_directory_matches_jax(tmp_path, carried):
    src = write_images(tmp_path / "images")
    yolo = YOLO("vil-det-tiny.yaml", device="cpu", compute_dtype=torch.float32)
    yolo.model.load_state_dict(carried.sd, strict=True)
    got = yolo.predict(str(src), imgsz=128, batch=2, conf=0.0)
    cfg = SimpleNamespace(imgsz=128, batch=2, conf=0.0, classes=None, augment=False,
                          vid_stride=1, iou=0.7, max_det=300)
    jax_predictor = JaxPredictor(cfg, {"model": carried.jm, "variables": carried.variables},
                                 dict(COCO_NAMES))
    # JAX's optional C++ letterbox differs from its LetterBox (cv2) by one level in places;
    # the port's device letterbox equals LetterBox, so JAX runs that path here
    jax_predictor._native_letterbox_batch = None
    ref = jax_predictor(str(src))
    assert [r.path for r in got] == [r.path for r in ref] and len(got) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.orig_img, r.orig_img)
        assert set(g.speed) == {"preprocess", "inference", "postprocess"}
        assert_topk_close(g.boxes.data, r.boxes.data)
    # augment=True on the end2end head: the plain forward
    one = [yolo.predict(str(src / "im0.jpg"), imgsz=128, conf=0.0, augment=augment)[0]
           for augment in (False, True)]
    np.testing.assert_array_equal(one[1].boxes.data, one[0].boxes.data)


# 5. AutoBackend ------------------------------------------------------------------------------

def test_autobackend_yaml_pt_sidecar_and_fusion(tmp_path, carried):
    yaml_ab = AutoBackend("vil-det-tiny.yaml", device="cpu", compute_dtype=torch.float32)
    assert yaml_ab.format == "yaml" and yaml_ab.imgsz == 160 and len(yaml_ab.names) == 80
    assert not any(k.endswith("running_mean") for k in yaml_ab.model.state_dict())

    pt = tmp_path / "best.pt"
    torch.save({"ema": carried.sd}, pt)
    (tmp_path / "best.pt.meta.json").write_text(json.dumps(
        {"epoch": 3, "args": {"model": "vil-det-tiny.yaml", "imgsz": 128, "task": "detect"}}))
    ab = AutoBackend(pt, device="cpu", compute_dtype=torch.float32)
    assert (ab.format, ab.imgsz, ab.names[5]) == ("torch", 128, "class5")
    ref = JaxAutoBackend(pt, model_cfg=TINY, imgsz=128, compute_dtype=jnp.float32, fuse=True)
    want = jax_variables_to_state_dict(jax.tree.map(np.asarray, ref.variables))
    got = ab.model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6, rtol=1e-6, err_msg=k)
    img = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(1))
    unfused = AutoBackend(pt, device="cpu", compute_dtype=torch.float32, fuse=False)
    torch.testing.assert_close(ab.warmup(2)(img), unfused(img), atol=1e-4, rtol=1e-4)

    # names from the sidecar's dataset YAML; nc follows them
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({"names": ["cat", "dog", "bird"]}))
    model3, _ = build_detection_model("vil-det-tiny.yaml", nc=3, device="cpu")
    torch.save(model3.state_dict(), tmp_path / "three.pt")
    (tmp_path / "three.pt.meta.json").write_text(json.dumps(
        {"args": {"model": "vil-det-tiny.yaml", "data": str(data)}}))
    ab3 = AutoBackend(tmp_path / "three.pt", device="cpu")
    assert ab3.names == {0: "cat", 1: "dog", 2: "bird"} and ab3.model.nc == 3

    (tmp_path / "bare.pt").write_bytes(pt.read_bytes())
    with pytest.raises(ValueError, match="model YAML"):
        AutoBackend(tmp_path / "bare.pt", device="cpu")
    (tmp_path / "ckpt_dir").mkdir()
    for weights, match in ((tmp_path / "ckpt_dir", "orbax"), ("m.stablehlo", "StableHLO"),
                           ("m.tflite", "TFLite")):
        with pytest.raises(NotImplementedError, match=match):
            AutoBackend(weights, device="cpu")


# 6. ThroughputEngine -------------------------------------------------------------------------

def test_engine_matches_jax_batch_for_batch():
    rng = np.random.default_rng(6)
    batches = [rng.integers(0, 256, (2, 12, 10, 3), dtype=np.uint8) for _ in range(8)]

    def port_fn(x):
        f = x.float() / 255.0
        return torch.cat([f.mean(dim=(1, 2)), f.amax(dim=(1, 2)) * f[:, 0, 0]], -1)

    def jax_fn(x):
        f = x.astype(jnp.float32) / 255.0
        return jnp.concatenate([f.mean(axis=(1, 2)), f.max(axis=(1, 2)) * f[:, 0, 0]], -1)

    got = list(ThroughputEngine(port_fn, scan=3, device="cpu")(iter(batches)))
    ref = list(JaxEngine(jax_fn, scan=3)(iter(batches)))  # 2 groups and a tail of 2
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=1e-6)


def test_engine_runs_the_predictor_forward(carried):
    from xlstm_yolo_tpu_torch.engine.predictor import DetectionPredictor

    predictor = DetectionPredictor({"imgsz": 128, "batch": 2}, carried.model, {})
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8) for _ in range(3)]
    got = list(ThroughputEngine(predictor.forward, scan=2, device="cpu")(batches))
    for g, b in zip(got, batches):
        np.testing.assert_array_equal(g, predictor.forward(torch.from_numpy(b)).numpy())
