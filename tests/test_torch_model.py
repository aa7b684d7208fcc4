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

The v1 route (``chunkwise_kernel="chunkwise--pallas_xl_chunk_siging"``)
rounds the operands of every cell product to bfloat16, in a float32 model
too.  On this network that turns float32 noise into one-step bfloat16
flips, which its depth amplifies: the port's own float32 and float64
forwards then differ by ~100 px and 0.3 in scores, and so do JAX's and the
port's.  So the route is held two ways: as it runs, against the float64
arbiter only; and with float32 products on both sides (its registry entry
given ``compute_dtype=float32`` in the JAX package's registry and the
port's, for the test), at the tolerances above and, for the gradients of
an E2E-loss step with open gates, at the tolerance stated there.
"""

import copy
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import leaves_by_name, make_batch
from xlstm_yolo_tpu.data.augment import LetterBox as JaxLetterBox
from xlstm_yolo_tpu.nn.head import dfl_decode as jax_dfl_decode
from xlstm_yolo_tpu.nn.head import topk_postprocess as jax_topk
from xlstm_yolo_tpu.nn.tasks import build_detection_model as jax_build
from xlstm_yolo_tpu.ops import backend as jax_backend
from xlstm_yolo_tpu.ops.pallas.chunkwise import mlstm_siging_chunkwise_pallas
from xlstm_yolo_tpu.utils import ops as jax_ops
from xlstm_yolo_tpu.utils import tal as jax_tal
from xlstm_yolo_tpu.utils.loss import e2e_detect_loss as jax_e2e_loss
from xlstm_yolo_tpu_torch.data.augment import LetterBox
from xlstm_yolo_tpu_torch.engine import steps
from xlstm_yolo_tpu_torch.engine.model import YOLO
from xlstm_yolo_tpu_torch.nn.head import dfl_decode, topk_postprocess
from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
from xlstm_yolo_tpu_torch.ops import backend
from xlstm_yolo_tpu_torch.ops import chunkwise as v1
from xlstm_yolo_tpu_torch.utils import ops, tal
from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

CFG = Path(__file__).resolve().parents[1] / "xlstm_yolo_tpu" / "cfg" / "models"
BOX_TOL = dict(atol=1.0, rtol=1e-3)
SCORE_ATOL = 3e-3
V1 = "chunkwise--pallas_xl_chunk_siging"
V1_GRAD_REL = 1e-2


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
        what = "boxes" if part.stop == 4 else "scores"
        assert err_jax <= 2 * err_port + atol, (
            f"{what}: JAX's float32 output is {err_jax:.6g} from the port's float64 forward, "
            f"the port's float32 output {err_port:.6g} (allowed: {2 * err_port + atol:.6g})")


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


def use_float32_products(mp):
    """Both registries' v1 entry with float32 products (float64 in the
    port's float64 arbiter), for the duration of ``mp``."""
    mp.setitem(jax_backend._CHUNKWISE_REGISTRY, "pallas_xl_chunk_siging",
               functools.partial(mlstm_siging_chunkwise_pallas, compute_dtype=jnp.float32))

    def port_v1(q, *args, **kw):
        cd = torch.float64 if q.dtype == torch.float64 else torch.float32
        return v1.mlstm_siging_chunkwise_v1(q, *args, compute_dtype=cd, **kw)
    mp.setitem(backend._REGISTRY["chunkwise"], "pallas_xl_chunk_siging", port_v1)


@pytest.fixture(scope="module")
def tiny_v1(tiny):
    """JAX's v1 route on ``tiny``'s variables (perturbed, open gates): the
    decode-only output as the route runs, and with float32 products the
    decode-only output and the loss and gradients of one E2E-loss step."""
    cfg, x = CFG / "vil-det-tiny.yaml", jnp.asarray(tiny["x"])
    out = {"y_route": np.asarray(jax.jit(jax_build(cfg, decode_only=True, chunkwise_kernel=V1)[0]
                                         .apply)(tiny["variables"], x)[0])}
    batch = make_batch(1)
    with pytest.MonkeyPatch.context() as mp:
        use_float32_products(mp)
        jm_dec, _ = jax_build(cfg, decode_only=True, chunkwise_kernel=V1)
        out["y_f32"] = np.asarray(jax.jit(jm_dec.apply)(tiny["variables"], x)[0])
        jm, _ = jax_build(cfg, training=True, chunkwise_kernel=V1)
        stats = tiny["variables"]["batch_stats"]

        def loss(params, b):
            img = b["img"].astype(jnp.float32) / 255.0
            maps, _ = jm.apply({"params": params, "batch_stats": stats}, img,
                               mutable=["batch_stats"], rngs={"droppath": jax.random.PRNGKey(3)})
            strides = [img.shape[1] / f.shape[1] for f in maps["one2many"]]
            return jax_e2e_loss(maps, b["cls"], b["bboxes"], b["mask"], strides, nc=80)[0]

        value, grads = jax.jit(jax.value_and_grad(loss))(
            tiny["variables"]["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(out, batch=batch, loss=float(value), grads=leaves_by_name(grads))


def test_tiny_v1_route_strict_load_and_decode_against_float64_arbiter(tiny, tiny_v1):
    """The route as it runs (bfloat16 products): the strict load of JAX's
    variables, and JAX's output no further from the port's float64 forward
    than twice the port's float32 one (both ~100 px off it here, so this
    holds the wiring only loosely; the next test holds it tightly)."""
    model, _ = build_detection_model("vil-det-tiny.yaml", decode_only=True, device="cpu",
                                     chunkwise_kernel=V1)
    model.load_state_dict(jax_variables_to_state_dict(tiny["variables"]), strict=True)
    assert all(m.chunkwise_kernel == V1 for m in model.modules() if isinstance(m, MatrixLSTMCell))
    assert_close_to_float64_arbiter(tiny_v1["y_route"], model, tiny["x"])


def test_tiny_v1_route_decode_only_matches_jax_with_float32_products(tiny, tiny_v1, monkeypatch):
    use_float32_products(monkeypatch)
    model = build_detection_model("vil-det-tiny.yaml", decode_only=True, device="cpu",
                                  chunkwise_kernel=V1)[0]
    model.load_state_dict(jax_variables_to_state_dict(tiny["variables"]), strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(tiny["x"]))[0].numpy()
    y_ref = tiny_v1["y_f32"]
    np.testing.assert_allclose(y[..., :4], y_ref[..., :4], **BOX_TOL)
    np.testing.assert_allclose(y[..., 4:], y_ref[..., 4:], atol=SCORE_ATOL)
    assert_close_to_float64_arbiter(y_ref, model, tiny["x"])


def test_tiny_v1_route_gradients_match_jax_with_open_gates(tiny, tiny_v1, monkeypatch):
    """One E2E-loss step of the training model under the v1 route, with
    open gates (a fifth of the denominators do not clamp): the JAX
    gradient goes through the Pallas custom VJP, which holds max(|.|, 1)
    constant, as the port's kernels do, so the two agree away from the
    clamp.  Float32 products on both sides.

    Tolerance: loss rtol 1e-4; gradients atol = V1_GRAD_REL of each leaf's
    largest |g| + 1e-6 of the largest |g| of all leaves, rtol = V1_GRAD_REL.
    With open gates this network amplifies float32 rounding further than at
    the default init: the worst leaf was 2.5e-3 of its largest |g| off, and
    the port's float32 gradient is as far from its float64 one (measured on
    the CPU); the biases ahead of a BatchNorm, whose true gradient is 0,
    hold only rounding."""
    use_float32_products(monkeypatch)
    dens = []
    fw = v1.chunkwise_fw

    def recording_fw(*args, **kw):
        out = fw(*args, **kw)
        dens.append(out[1])
        return out
    monkeypatch.setattr(v1, "chunkwise_fw", recording_fw)
    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu", training=True,
                                     chunkwise_kernel=V1)
    model.load_state_dict(jax_variables_to_state_dict(tiny["variables"]), strict=True)
    loss, _ = steps.detect_loss(model, {k: torch.from_numpy(v) for k, v in
                                        tiny_v1["batch"].items()})
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    assert len(dens) == 14  # one cell call per ViL layer, each padded to whole chunks
    assert 0.1 < float(torch.cat([d.flatten() for d in dens]).gt(1).float().mean()) < 0.9
    np.testing.assert_allclose(loss.item(), tiny_v1["loss"], rtol=1e-4)
    ref = tiny_v1["grads"]
    assert set(ref) == set(grads)
    g_max = max(np.abs(g).max() for g in ref.values())
    for name, g_ref in ref.items():
        atol = V1_GRAD_REL * np.abs(g_ref).max() + 1e-6 * g_max
        np.testing.assert_allclose(grads[name].numpy(), g_ref, atol=atol, rtol=V1_GRAD_REL,
                                   err_msg=name)
