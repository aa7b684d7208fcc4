"""The port's detector held against the JAX package, end to end.

``vil-det-tiny`` at 160 px, batch 2: the JAX model is initialised on CPU,
its ifgates are perturbed so every mLSTM cell is far from inert, and the
same variables are carried into the port with ``jax_variables_to_state_dict``
and a strict load.  Inputs are made with numpy from a seed; float32.

Tolerances.  Each module agrees to 2e-4 (test_torch_layers), but with
active cells this random network amplifies float32 rounding through its
29 layers and the DFL decode.  A float64 run of the port is the arbiter:
on these inputs the JAX float32 forward deviates from it by up to 0.26 px
in decoded boxes and 7.6e-4 in scores, the port's by 0.18 px and 9.2e-4.
So the two float32 forwards are held to atol = 1 px (rtol = 1e-3) in boxes
and atol = 3e-3 in scores; a wiring fault moves them by O(1).
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.data.augment import LetterBox as JaxLetterBox
from xlstm_yolo_tpu.nn.head import dfl_decode as jax_dfl_decode
from xlstm_yolo_tpu.nn.head import topk_postprocess as jax_topk
from xlstm_yolo_tpu.nn.tasks import build_detection_model as jax_build
from xlstm_yolo_tpu.utils import ops as jax_ops
from xlstm_yolo_tpu.utils import tal as jax_tal
from xlstm_yolo_tpu_torch.data.augment import LetterBox
from xlstm_yolo_tpu_torch.engine.model import YOLO
from xlstm_yolo_tpu_torch.nn.head import dfl_decode, topk_postprocess
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
from xlstm_yolo_tpu_torch.utils import ops, tal
from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict

CFG = Path(__file__).resolve().parents[1] / "xlstm_yolo_tpu" / "cfg" / "models"
BOX_TOL = dict(atol=1.0, rtol=1e-3)
SCORE_ATOL = 3e-3


def perturb_ifgates(variables, rng):
    """ifgate kernel ~ N(0, 0.01), input-gate bias ~ U(-3, 1)."""
    def walk(tree, parent):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val, key)
            elif parent == "ifgate" and key == "kernel":
                out[key] = (0.01 * rng.normal(size=val.shape)).astype(np.float32)
            elif parent == "ifgate" and key == "bias":
                nh = val.shape[0] // 2
                out[key] = np.concatenate([rng.uniform(-3, 1, nh).astype(np.float32), val[nh:]])
            else:
                out[key] = val
        return out
    return {col: walk(tree, None) for col, tree in variables.items()}


def jax_detector(cfg_name, batch, seed=0):
    """(JAX decode-only model, JAX default model, variables, input)."""
    rng = np.random.default_rng(seed)
    jm_dec, d = jax_build(CFG / cfg_name, decode_only=True)
    jm, _ = jax_build(CFG / cfg_name)
    size = int(d["imgsz"])
    x = rng.normal(0.45, 0.2, (batch, size, size, 3)).astype(np.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = perturb_ifgates(jax.tree.map(np.asarray, variables), rng)
    return jm_dec, jm, variables, x


def port_detector(cfg_name, variables, decode_only):
    model, _ = build_detection_model(cfg_name, decode_only=decode_only, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return model


def assert_topk_close(y, y_ref):
    """(K, 6) top-k rows: scores agree row by row; rows whose score is
    clear of both neighbours (an unambiguous rank) agree in box and class.
    Rows closer than twice the score tolerance may legitimately swap."""
    np.testing.assert_allclose(y[:, 4], y_ref[:, 4], atol=SCORE_ATOL)
    s = y_ref[:, 4]
    gap = np.minimum(np.abs(np.diff(s, prepend=np.inf)), np.abs(np.diff(s, append=-np.inf)))
    clear = gap > 2 * SCORE_ATOL
    assert clear.sum() >= 3, "too few unambiguous rows to compare"
    np.testing.assert_allclose(y[clear, :4], y_ref[clear, :4], **BOX_TOL)
    np.testing.assert_array_equal(y[clear, 5], y_ref[clear, 5])


@pytest.fixture(scope="module")
def tiny():
    jm_dec, jm, variables, x = jax_detector("vil-det-tiny.yaml", batch=2)
    return dict(jm_dec=jm_dec, jm=jm, variables=variables, x=x,
                apply=jax.jit(jm.apply), apply_dec=jax.jit(jm_dec.apply))


def test_strict_state_dict_load(tiny):
    sd = jax_variables_to_state_dict(tiny["variables"])
    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    model.load_state_dict(sd, strict=True)


def test_tiny_decode_only_matches_jax(tiny):
    y_ref, _ = tiny["apply_dec"](tiny["variables"], jnp.asarray(tiny["x"]))
    y_ref = np.asarray(y_ref)
    model = port_detector("vil-det-tiny.yaml", tiny["variables"], decode_only=True)
    with torch.no_grad():
        y, aux = model(torch.from_numpy(tiny["x"]))
    y = y.numpy()
    assert y.shape == y_ref.shape == (2, 20 * 20 + 10 * 10 + 5 * 5, 84)
    assert [m.shape[1] for m in aux["one2one"]] == [20, 10, 5]
    np.testing.assert_allclose(y[..., :4], y_ref[..., :4], **BOX_TOL)
    np.testing.assert_allclose(y[..., 4:], y_ref[..., 4:], atol=SCORE_ATOL)


def test_tiny_topk_output_matches_jax(tiny):
    y_ref, _ = tiny["apply"](tiny["variables"], jnp.asarray(tiny["x"]))
    y_ref = np.asarray(y_ref)
    model = port_detector("vil-det-tiny.yaml", tiny["variables"], decode_only=False)
    with torch.no_grad():
        y, _ = model(torch.from_numpy(tiny["x"]))
    assert y.shape == y_ref.shape == (2, 300, 6)
    for b in range(2):
        assert_topk_close(y[b].numpy(), y_ref[b])


def test_topk_postprocess_matches_jax(tiny):
    """The same decoded array through both top-k stages: identical rows."""
    dec, _ = tiny["apply_dec"](tiny["variables"], jnp.asarray(tiny["x"]))
    dec = np.array(dec)  # writable copy for torch.from_numpy
    ref = np.asarray(jax_topk(jnp.asarray(dec), 300, 80))
    out = topk_postprocess(torch.from_numpy(dec), 300, 80).numpy()
    np.testing.assert_array_equal(out, ref)


def _anchors_and_boxes(rng):
    shapes, strides = [(4, 6), (2, 3)], [8.0, 16.0]
    dist = rng.uniform(0, 15, (2, 30, 4)).astype(np.float32)
    ref_pts, ref_st = jax_tal.make_anchors(shapes, strides)
    pts, st = tal.make_anchors(shapes, strides)
    out = []
    for xywh in (True, False):
        ref = np.asarray(jax_tal.dist2bbox(jnp.asarray(dist), ref_pts[None], xywh=xywh))
        out.append((tal.dist2bbox(torch.from_numpy(dist), pts[None], xywh=xywh).numpy(), ref))
    return [(pts.numpy(), np.asarray(ref_pts)), (st.numpy(), np.asarray(ref_st))] + out


def _dfl(rng):
    dist = (3 * rng.normal(size=(2, 30, 64))).astype(np.float32)
    return [(dfl_decode(torch.from_numpy(dist)).numpy(), np.asarray(jax_dfl_decode(jnp.asarray(dist))))]


def _scale_boxes(rng):
    boxes = rng.uniform(-20, 700, (50, 4)).astype(np.float32)
    out = []
    for img0, ratio_pad, padding in (((480, 640), None, True), ((720, 1280), None, False),
                                     ((375, 500), ((1.28, 1.28), (0, 80)), True)):
        ref = jax_ops.scale_boxes((640, 640), boxes, img0, ratio_pad, padding)
        out.append((ops.scale_boxes((640, 640), boxes, img0, ratio_pad, padding), np.asarray(ref)))
    return out


@pytest.mark.parametrize("make", [_anchors_and_boxes, _dfl, _scale_boxes],
                         ids=["anchors_dist2bbox", "dfl_decode", "scale_boxes"])
def test_box_utils_match_jax(make):
    """The decode and box-scaling helpers against JAX on the same numpy
    inputs; float32, atol = rtol = 1e-5 (elementwise math only)."""
    for got, ref in make(np.random.default_rng(11)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_predictor_end_to_end(tiny):
    """YOLO(...).predict on two images of different shapes: letterbox
    geometry and pixels equal the JAX LetterBox; for the image that needs
    only padding, the boxes after scale_boxes match the JAX path."""
    rng = np.random.default_rng(3)
    pad_only = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)  # r = 1, pad 20 + 20
    resized = rng.integers(0, 256, (300, 200, 3), dtype=np.uint8)
    for im in (pad_only, resized):
        ref_img, ref_ratio, ref_pad = JaxLetterBox((160, 160))(im)
        out, ratio, pad = LetterBox((160, 160))(torch.from_numpy(im))
        assert (ratio, pad, tuple(out.shape)) == (ref_ratio, ref_pad, ref_img.shape)
        np.testing.assert_array_equal(out.numpy(), ref_img)

    yolo = YOLO("vil-det-tiny.yaml", device="cpu", compute_dtype=torch.float32)
    yolo.model.load_state_dict(jax_variables_to_state_dict(tiny["variables"]),
                                      strict=True)
    results = yolo.predict([pad_only, resized], conf=0.0, batch=2)
    assert [r.orig_img.shape for r in results] == [pad_only.shape, resized.shape]
    for r in results:
        assert len(r) == 300 and np.isfinite(r.boxes.data).all()
        h, w = r.orig_img.shape[:2]
        assert (r.boxes.xyxy >= 0).all() and (r.boxes.xyxy[:, [0, 2]] <= w).all()
        assert (r.boxes.xyxy[:, [1, 3]] <= h).all()

    lb = JaxLetterBox((160, 160))(pad_only)[0][..., ::-1]  # BGR -> RGB, as predicted
    x = jnp.asarray(lb[None].astype(np.float32) / 255.0)
    det = np.asarray(tiny["apply"](tiny["variables"], x)[0])[0]
    ref = np.concatenate(
        [jax_ops.scale_boxes((160, 160), det[:, :4], pad_only.shape[:2]), det[:, 4:]], 1)
    assert_topk_close(results[0].boxes.data, ref)


def assert_close_to_float64_arbiter(y_jax, model, x):
    """Deep random networks with active cells amplify float32 rounding (the
    flagship's float32 forwards differ by tens of px in boxes of magnitude
    ~1e3; PERF.md), so a float64 forward of the port is the arbiter: the JAX
    float32 output must be no further from it than twice the port's own
    float32 output is, plus 1 px in boxes and 3e-3 in scores.  A port that
    computed another function would sit far from the JAX output while its
    own float32 and float64 forwards agreed."""
    with torch.no_grad():
        y = model(torch.from_numpy(x))[0].numpy()
        y64 = copy.deepcopy(model).double()(torch.from_numpy(x).double())[0].numpy()
    assert y.shape == y_jax.shape and np.isfinite(y).all()
    for part, atol in ((slice(0, 4), BOX_TOL["atol"]), (slice(4, None), SCORE_ATOL)):
        err_jax = np.abs(y_jax[..., part] - y64[..., part]).max()
        err_port = np.abs(y[..., part] - y64[..., part]).max()
        assert err_jax <= 2 * err_port + atol, (part, err_jax, err_port)


def test_tiny_decode_only_against_float64_arbiter(tiny):
    y_ref, _ = tiny["apply_dec"](tiny["variables"], jnp.asarray(tiny["x"]))
    model = port_detector("vil-det-tiny.yaml", tiny["variables"], decode_only=True)
    assert_close_to_float64_arbiter(np.asarray(y_ref), model, tiny["x"])


@pytest.mark.slow
@pytest.mark.parametrize("imgsz", [128, 640])
def test_flagship_decode_only_matches_jax(imgsz, tmp_path):
    """vil-det-192 at full width and depth (dim 192, 20 ViL layers, every
    fusion block), batch 1, float32 on CPU: the port's decode-only forward
    against the JAX one, with the port's float64 forward as the arbiter.
    640 px is the published size; 128 px is the same graph on a copy of the
    YAML whose image size, grids and PatchMerger token counts are scaled by
    1/5 (S = 256, 64, 16, 4), widths and chunk sizes unchanged."""
    cfg = "vil-det-192.yaml"
    if imgsz != 640:
        text = (CFG / cfg).read_text()
        for old, new in (("imgsz: 640", "imgsz: 128"), ("[640, 640]", "[128, 128]"),
                         ("[80, 80]", "[16, 16]"), ("[40, 40]", "[8, 8]"),
                         ("[20, 20]", "[4, 4]"), ("[10, 10]", "[2, 2]"),
                         ("[192, 1600]", "[192, 64]"), ("[192, 400]", "[192, 16]"),
                         ("[192, 100]", "[192, 4]")):
            assert old in text
            text = text.replace(old, new)
        (tmp_path / cfg).write_text(text)
        cfg = tmp_path / cfg
    jm_dec, _, variables, x = jax_detector(cfg, batch=1)
    y_ref = np.asarray(jax.jit(jm_dec.apply)(variables, jnp.asarray(x))[0])
    g = imgsz // 8
    assert y_ref.shape == (1, g * g + (g // 2) ** 2 + (g // 4) ** 2 + (g // 8) ** 2, 84)
    model = port_detector(cfg, variables, decode_only=True)
    assert_close_to_float64_arbiter(y_ref, model, x)
