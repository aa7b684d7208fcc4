"""The detector at other input sizes, and BN folding, held against the JAX
package on the CPU.

- ``utils/resize.py`` against ``jax.image.resize`` (bicubic and bilinear,
  up and down; float32 to 1e-5 of the output's scale) and its gradient
  against ``jax.grad`` of the same resize (1e-5); ``F.interpolate`` with its
  default ``antialias=False`` misses JAX by more than 0.3 at the same
  shapes, which is why the port does not call it.
- ``resolve_seqlens`` against JAX's over a range of S: the same grids, and
  a ValueError where JAX asserts; the grids of ``vil-det-192`` at 512 and
  768 px, and the refusal at 544 (72 queries) before any layer runs.
- ``VitPosEmbed2d`` and ``PatchMerger`` at non-base grids with carried
  weights: forward, and the gradient of ``embed`` and ``queries``, at the
  modules' tolerance of ``tests/test_torch_layers.py`` (2e-4); the
  non-square query grid raises JAX's message.
- ``vil-det-tiny``'s eval forward at 128 and 192 px (grids (16, 8, 4) and
  (24, 12, 6)) against JAX's on the same weights, at the tolerances of
  ``tests/test_torch_model.py``; predict at 192 and val at 128 run.
- The train step's bucket: the batch resized and its boxes scaled as JAX's
  step does (1e-5), a ViL block pair's training gradient at a rescaled grid
  against ``jax.grad`` (2e-4), and (slow: JAX's step is a jit of about
  80 s) the whole step at ``imgsz_out=192`` against JAX's.
- ``train(multi_scale=True)`` on the tiny detector: the buckets printed,
  and the bucket of each step, over two epochs, JAX's draw.
- ``fuse_state_dict`` equals JAX's ``fuse_variables`` carried through the
  converter; the fused model's output equals the unfused one's (1e-5 of
  its scale) and JAX's fused model's (the model tolerances).
- A ``conv_kind="none"`` ``ViLLayer`` against JAX's, with a strict load.

Inputs are made with numpy from a seed; torch runs on one thread.
"""

import contextlib
import io
import random
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_layers import TOL, randomize
from test_torch_model import BOX_TOL, SCORE_ATOL
from test_torch_train_loader import one_thread, write_train_set  # noqa: F401
from xlstm_yolo_tpu.nn import blocks as jb
from xlstm_yolo_tpu.nn import layers as jl
from xlstm_yolo_tpu.nn.tasks import build_detection_model as jax_build
from xlstm_yolo_tpu.utils.fuse import fuse_variables
from xlstm_yolo_tpu_torch.engine import steps
from xlstm_yolo_tpu_torch.engine.model import YOLO
from xlstm_yolo_tpu_torch.nn import blocks as tb
from xlstm_yolo_tpu_torch.nn import layers as tl
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model, parse_model_specs, \
    token_grids, yaml_model_load
from xlstm_yolo_tpu_torch.utils.convert import jax_path_to_name, jax_variables_to_state_dict
from xlstm_yolo_tpu_torch.utils.fuse import fuse_state_dict
from xlstm_yolo_tpu_torch.utils.resize import resize

CFG = Path(__file__).resolve().parents[1] / "xlstm_yolo_tpu" / "cfg" / "models"
RESIZE_TOL = 1e-5


def close(got, ref, rel):
    """Within ``rel`` of the reference's largest |value| (atol) and rtol."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * max(np.abs(ref).max(), 1e-30), rtol=rel)


# ---------------------------------------------------------------------------
# the resize

RESIZE_CASES = [  # (input shape, output shape, method)
    ((1, 40, 40, 16), (1, 32, 32, 16), "bicubic"),
    ((1, 40, 40, 16), (1, 48, 48, 16), "bicubic"),
    ((1, 32, 32, 16), (1, 40, 40, 16), "bicubic"),
    ((1, 48, 48, 16), (1, 40, 40, 16), "bicubic"),
    ((1, 10, 10, 16), (1, 8, 8, 16), "bicubic"),
    ((10, 10, 32), (8, 8, 32), "bicubic"),          # a PatchMerger's query grid
    ((1, 40, 40, 16), (1, 32, 32, 16), "bilinear"),
    ((1, 40, 40, 16), (1, 48, 48, 16), "bilinear"),
    ((1, 10, 10, 16), (1, 8, 8, 16), "bilinear"),
    ((2, 160, 160, 3), (2, 128, 128, 3), "bilinear"),  # the train step's batch
    ((2, 160, 160, 3), (2, 192, 192, 3), "bilinear"),
    ((2, 160, 160, 3), (2, 192, 192, 3), "bicubic"),
]


def _case_id(case):
    a, b, m = case
    return f"{m}-{a[-3]}to{b[-3]}"


@pytest.mark.parametrize("case", RESIZE_CASES, ids=[_case_id(c) for c in RESIZE_CASES])
def test_resize_matches_jax(case):
    shape_in, shape_out, method = case
    x = np.random.default_rng(zlib.crc32(_case_id(case).encode())).normal(
        size=shape_in).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), shape_out, method))
    close(resize(torch.from_numpy(x), shape_out, method).numpy(), ref, RESIZE_TOL)


@pytest.mark.parametrize("case", [RESIZE_CASES[i] for i in (0, 1, 4, 9, 10)],
                         ids=[_case_id(RESIZE_CASES[i]) for i in (0, 1, 4, 9, 10)])
def test_resize_gradient_matches_jax(case):
    shape_in, shape_out, method = case
    rng = np.random.default_rng(zlib.crc32(("grad" + _case_id(case)).encode()))
    x = rng.normal(size=shape_in).astype(np.float32)
    w = rng.normal(size=shape_out).astype(np.float32)
    ref = np.asarray(jax.grad(lambda a: (jax.image.resize(a, shape_out, method)
                                         * jnp.asarray(w)).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (resize(xt, shape_out, method) * torch.from_numpy(w)).sum().backward()
    close(xt.grad.numpy(), ref, RESIZE_TOL)


def test_resize_cache_serves_inference_and_autograd():
    """A weight matrix first built under inference mode (predict at a size)
    serves a later differentiable resize at that size (a bucket step)."""
    shape_in, shape_out = (1, 13, 13, 4), (1, 11, 11, 4)
    with torch.inference_mode():
        resize(torch.ones(shape_in), shape_out, "bicubic")
    x = torch.ones(shape_in, requires_grad=True)
    resize(x, shape_out, "bicubic").sum().backward()
    assert torch.isfinite(x.grad).all()


def test_interpolate_without_antialias_misses_jax():
    """The trap the port's resize avoids: ``F.interpolate`` with its default
    ``antialias=False`` is far from JAX when downsampling (and bicubic,
    a = -0.75, upsampling too)."""
    x = np.random.default_rng(3).normal(size=(1, 40, 40, 16)).astype(np.float32)
    for size, method in ((32, "bicubic"), (48, "bicubic"), (32, "bilinear")):
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, size, size, 16), method))
        got = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=(size, size), mode=method,
            align_corners=False).permute(0, 2, 3, 1).numpy()
        assert np.abs(got - ref).max() > 0.3, (size, method)


# ---------------------------------------------------------------------------
# grids

@pytest.mark.parametrize("base", [(20, 20), (10, 10), (5, 5), (80, 80), (4, 6)])
def test_resolve_seqlens_matches_jax(base):
    for S in list(range(1, 700)) + [4096, 6400, 9216, 2304, 576, 144]:
        try:
            ref = jl.resolve_seqlens(S, base)
        except AssertionError as e:
            with pytest.raises(ValueError, match="incompatible with base grid"):
                tl.resolve_seqlens(S, base)
            assert "incompatible" in str(e)
        else:
            assert tl.resolve_seqlens(S, base) == ref, S


def test_grid_of_without_seqlens_is_square():
    assert tl.grid_of(49, None) == (7, 7)
    with pytest.raises(ValueError, match="not square"):
        tl.grid_of(50, None)


def test_vil_det_192_grids_at_other_sizes():
    """The four stages of vil-det-192 at 512 and 768 px, as JAX's
    PatchMerger and resolve_seqlens rescale them; at 544 px (TTA's 0.83 of
    640, padded) the last PatchMerger's 72 queries are no square grid."""
    specs, _, _ = parse_model_specs(yaml_model_load(CFG / "vil-det-192.yaml"))
    for size, stages in ((640, (6400, 1600, 400, 100)), (512, (4096, 1024, 256, 64)),
                         (768, (9216, 2304, 576, 144))):
        grids = token_grids(specs, (size, size))
        assert tuple(grids[i][1] for i in (2, 4, 6, 8)) == stages
        assert [grids[i][1:] for i in (21, 24, 27, 30)] == [
            (size // p, size // p) for p in (8, 16, 32, 64)]
    with pytest.raises(ValueError, match="M=100, scaled M'=72"):
        token_grids(specs, (544, 544))


def test_size_refused_before_any_layer_runs():
    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu")
    calls = []
    model.model[0].register_forward_hook(lambda *a: calls.append(1))
    with pytest.raises(ValueError, match="square query grids"):
        model(torch.zeros(1, 136, 136, 3))
    assert not calls


# ---------------------------------------------------------------------------
# modules at non-base grids

def carried(jm, args, rng):
    """JAX variables of ``jm`` randomised, and the port state dict of the
    same values."""
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), *args))
    variables = randomize(variables, rng)
    return variables, jax_variables_to_state_dict(variables)


@pytest.mark.parametrize("grid", [(4, 4), (6, 6), (16, 16), (24, 24)])
def test_pos_embed_resize_matches_jax(grid):
    base = (5, 5) if grid[0] < 10 else (20, 20)
    rng = np.random.default_rng(grid[0])
    x = rng.normal(size=(2, *grid, 8)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jm = jl.VitPosEmbed2d(seqlens=base, dim=8)
    variables, sd = carried(jm, [jnp.asarray(x)], rng)
    pm = tl.VitPosEmbed2d(base, 8)
    pm.load_state_dict(sd, strict=True)

    def loss(v):
        return (jm.apply(v, jnp.asarray(x)) * jnp.asarray(w)).sum()

    g_ref = jax.grad(loss)(variables)["params"]["embed"]
    y = pm(torch.from_numpy(x))
    close(y.detach().numpy(), jm.apply(variables, jnp.asarray(x)), TOL["rtol"])
    (y * torch.from_numpy(w)).sum().backward()
    close(pm.embed.grad.numpy(), g_ref, TOL["rtol"])


@pytest.mark.parametrize("n_in", [64, 100, 144])
def test_patch_merger_rescaled_matches_jax(n_in):
    """PatchMerger(32, 25) on a 100-token base at 64 (16 queries), 100 and
    144 (36) tokens: forward and the gradient of its queries."""
    rng = np.random.default_rng(n_in)
    x = (0.5 + rng.normal(size=(2, n_in, 32))).astype(np.float32)
    jm = jb.PatchMerger(dim=32, num_tokens_out=25, base_tokens_in=100)
    variables, sd = carried(jm, [jnp.asarray(x)], rng)
    pm = tb.PatchMerger(32, 25, base_tokens_in=100)
    pm.load_state_dict(sd, strict=True)
    y_ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    w = rng.normal(size=y_ref.shape).astype(np.float32)
    g_ref = jax.grad(lambda v: (jm.apply(v, jnp.asarray(x)) * jnp.asarray(w)).sum())(
        variables)["params"]["queries"]
    y = pm(torch.from_numpy(x))
    assert y.shape[1] == {64: 16, 100: 25, 144: 36}[n_in]
    close(y.detach().numpy(), y_ref, TOL["rtol"])
    (y * torch.from_numpy(w)).sum().backward()
    close(pm.queries.grad.numpy(), g_ref, TOL["rtol"])


def test_patch_merger_non_square_raises_jax_message():
    x = jnp.zeros((1, 72, 32))
    jm = jb.PatchMerger(dim=32, num_tokens_out=25, base_tokens_in=100)
    with pytest.raises(AssertionError) as ref:
        jm.init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError) as got:
        tb.PatchMerger(32, 25, base_tokens_in=100)(torch.zeros(1, 72, 32))
    assert str(got.value) == str(ref.value)


def test_conv_kind_none_vil_layer_matches_jax():
    rng = np.random.default_rng(17)
    x = rng.normal(size=(2, 25, 32)).astype(np.float32)
    kw = dict(seqlens=(5, 5), qkv_block_size=16, conv_kind="none")
    jm = jl.ViLLayer(dim=32, direction=jl.BACKWARD, **kw)
    variables, sd = carried(jm, [jnp.asarray(x)], rng)
    pm = tl.ViLLayer(32, tl.BACKWARD, **kw)
    assert pm.conv is None and not any(k.startswith("conv.") for k in pm.state_dict())
    pm.load_state_dict(sd, strict=True)
    pm.eval()
    with torch.no_grad():
        y = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jm.apply(variables, jnp.asarray(x))), **TOL)


# ---------------------------------------------------------------------------
# the detector at 128 and 192 px, and folded

def jax_tree_of(model, shapes) -> dict:
    """The JAX variables tree of ``shapes`` (``jax.eval_shape`` of init)
    holding ``model``'s tensors: the inverse of the converter's layouts."""
    sd = model.state_dict()

    def walk(tree, path):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val, path + (key,))
                continue
            name, kind = jax_path_to_name(path + (key,))
            t = sd[name].detach().numpy()
            if kind == "kernel":
                t = {2: lambda a: a.T, 3: lambda a: a.transpose(2, 1, 0),
                     4: lambda a: a.transpose(2, 3, 1, 0)}.get(t.ndim, lambda a: a)(t)
            assert t.shape == val.shape, name
            out[key] = np.ascontiguousarray(t, dtype=np.float32)
        return out

    return {col: walk(tree, (col,)) for col, tree in shapes.items()}


@pytest.fixture(scope="module")
def tiny():
    """The tiny decode-only detector (seed 0, ifgates perturbed, BatchNorm
    statistics moved off 0/1 so folding them shows), in the port and as a
    JAX variables tree of the same values."""
    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu", decode_only=True)
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("ifgate.weight"):
                t.copy_(torch.from_numpy(0.01 * rng.normal(size=t.shape)))
            elif name.endswith("ifgate.bias"):
                nh = t.shape[0] // 2
                t[:nh] = torch.from_numpy(rng.uniform(-3, 1, nh))
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy(0.05 * rng.normal(size=t.shape)))
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.7, 1.4, t.shape)))
    jm, _ = jax_build(CFG / "vil-det-tiny.yaml", decode_only=True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 160, 160, 3)))
    variables = jax_tree_of(model, shapes)
    return dict(model=model, jm=jm, variables=variables, apply=jax.jit(jm.apply))


@pytest.mark.parametrize("size,grids", [(128, (16, 8, 4)), (192, (24, 12, 6))])
def test_tiny_forward_at_size_matches_jax(tiny, size, grids):
    x = np.random.default_rng(size).normal(0.45, 0.2, (2, size, size, 3)).astype(np.float32)
    y_ref, _ = tiny["apply"](tiny["variables"], jnp.asarray(x))
    y_ref = np.asarray(y_ref)
    with torch.no_grad():
        y, aux = tiny["model"](torch.from_numpy(x))
    assert [m.shape[1] for m in aux["one2one"]] == list(grids)
    assert y.shape == y_ref.shape == (2, sum(g * g for g in grids), 84)
    y = y.numpy()
    np.testing.assert_allclose(y[..., :4], y_ref[..., :4], **BOX_TOL)
    np.testing.assert_allclose(y[..., 4:], y_ref[..., 4:], atol=SCORE_ATOL)


def test_fuse_matches_jax(tiny):
    """fuse_state_dict of the carried weights equals JAX's fuse_variables
    carried; the fused port model's output equals the unfused one's, and
    JAX's fused model's."""
    ref = jax_variables_to_state_dict(fuse_variables(tiny["variables"]))
    got = fuse_state_dict(tiny["model"].state_dict())
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    fused, _ = build_detection_model("vil-det-tiny.yaml", device="cpu", decode_only=True,
                                     fused=True)
    fused.load_state_dict(got, strict=True)
    with pytest.raises(ValueError, match="eval-only"):
        fused.train()
    x = np.random.default_rng(160).normal(0.45, 0.2, (2, 160, 160, 3)).astype(np.float32)
    with torch.no_grad():
        y_fused = fused(torch.from_numpy(x))[0].numpy()
        y = tiny["model"](torch.from_numpy(x))[0].numpy()
    close(y_fused, y, 1e-5)
    jm_f, _ = jax_build(CFG / "vil-det-tiny.yaml", decode_only=True, fused=True)
    y_ref = np.asarray(jax.jit(jm_f.apply)(fuse_variables(tiny["variables"]),
                                           jnp.asarray(x))[0])
    np.testing.assert_allclose(y_fused[..., :4], y_ref[..., :4], **BOX_TOL)
    np.testing.assert_allclose(y_fused[..., 4:], y_ref[..., 4:], atol=SCORE_ATOL)


def test_predict_and_val_at_other_sizes(tmp_path):
    """YOLO(tiny).predict at 192 px and .val at 128 px run through the
    rescaled model: results in the original image's coordinates."""
    rng = np.random.default_rng(9)
    im = rng.integers(0, 256, (150, 230, 3), dtype=np.uint8)
    yolo = YOLO("vil-det-tiny.yaml", device="cpu", compute_dtype=torch.float32)
    (r,) = yolo.predict(im, imgsz=192, conf=0.0)
    d = r.boxes.data
    assert len(r) == 300 and np.isfinite(d).all()
    assert (d[:, [0, 2]] <= 230).all() and (d[:, [1, 3]] <= 150).all()
    data = write_train_set(tmp_path, 4, seed=5, split="val")
    res = yolo.val(data=str(data), imgsz=128, batch=2, workers=0)
    assert yolo.validator.seen == 4 and all(np.isfinite(float(v)) for v in res.values())


# ---------------------------------------------------------------------------
# the train step's buckets

def test_rescale_batch_matches_jax():
    """A 160 px uint8 batch at buckets 128 and 192: the images as JAX's step
    resizes them (float32 / 255, bilinear) and the boxes scaled by
    bucket / 160; at 160 nothing changes."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, 160, 160, 3), dtype=np.uint8)
    boxes = rng.uniform(0, 160, (2, 5, 4)).astype(np.float32)
    for out in (128, 160, 192):
        x = jnp.asarray(img).astype(jnp.float32) / 255.0
        ref = x if out == 160 else jax.image.resize(x, (2, out, out, 3), "bilinear")
        got, got_boxes = steps.rescale_batch(torch.from_numpy(img), torch.from_numpy(boxes), out)
        close(got.numpy(), ref, RESIZE_TOL)
        np.testing.assert_allclose(got_boxes.numpy(), boxes * np.float32(out / 160), rtol=1e-7)


def test_block_pair_training_gradient_at_rescaled_grid_matches_jax():
    """A ViL block pair declared at 5x5 run in training on a 6x6 grid (the
    conv on the grid resolve_seqlens gives): the input's and every
    parameter's gradient against jax.grad, at the gate init (input-gate
    bias -10) where both cells' denominators clamp to 1."""
    rng = np.random.default_rng(23)
    x = rng.normal(size=(2, 36, 32)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    kw = dict(seqlens=(5, 5), qkv_block_size=16)
    jm = jl.ViLBlockPair(dim=32, training=True, **kw)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = randomize(init, rng)

    def keep_gates(tree, ref, parent=None):  # the ifgate at its init
        return {k: keep_gates(v, ref[k], k) if isinstance(v, dict) else
                (ref[k] if parent == "ifgate" else v) for k, v in tree.items()}

    variables = {"params": keep_gates(variables["params"], init["params"])}

    def loss(v, a):
        return (jm.apply(v, a, rngs={"droppath": jax.random.PRNGKey(1)})
                * jnp.asarray(w)).sum()

    g_ref, gx_ref = jax.grad(loss, argnums=(0, 1))(variables, jnp.asarray(x))
    ref = jax_variables_to_state_dict(jax.tree.map(np.asarray, g_ref))
    pm = tl.ViLBlockPair(32, **kw)
    pm.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    pm.train()
    xt = torch.from_numpy(x).requires_grad_()
    (pm(xt) * torch.from_numpy(w)).sum().backward()
    close(xt.grad.numpy(), gx_ref, TOL["rtol"])
    g_max = max(np.abs(g.numpy()).max() for g in ref.values())
    for name, p in pm.named_parameters():
        g = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * np.abs(g).max() + 1e-6 * g_max,
                                   err_msg=name)


@pytest.mark.slow
def test_train_step_at_bucket_matches_jax():
    """One train step of vil-det-tiny from 160 px batches at bucket 192
    (imgsz_out) against JAX's: the loss items and the gradients the
    optimizer received, at tests/test_torch_train_step.py's tolerances."""
    from test_torch_train_step import OPT_KW, jax_moments, make_batch, port_moments
    from xlstm_yolo_tpu.engine import optimizers as jax_opt
    from xlstm_yolo_tpu.engine import steps as jax_steps
    from xlstm_yolo_tpu_torch.engine import optimizers as opt
    from xlstm_yolo_tpu_torch.utils.convert import jax_train_state_to_torch

    jm, _ = jax_build(CFG / "vil-det-tiny.yaml", training=True)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 160, 160, 3), jnp.float32)))
    tx, _, _ = jax_opt.build_optimizer(variables["params"], **OPT_KW)
    jstep = jax.jit(jax_steps.make_train_step(jm, tx, nc=80, imgsz_out=192))
    batch = make_batch(1)
    jstate, jmetrics = jstep(jax_steps.TrainState.create(variables, tx),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(3))
    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu", training=True)
    sd, _ = jax_train_state_to_torch(variables["params"], variables["batch_stats"],
                                     variables["params"])
    model.load_state_dict(sd, strict=True)
    ptx, _, _ = opt.build_optimizer(steps.optimizer_leaves(model), **OPT_KW)
    pstate, metrics = steps.make_train_step(model, ptx, nc=80, imgsz_out=192)(
        steps.TrainState.create(model, ptx), {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(3))
    for key in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-4,
                                   err_msg=key)
    b1 = 0.937
    ref = jax_moments(jax.tree.map(np.asarray, jstate.opt_state), "m_fast")
    got = port_moments(model, pstate, "m_fast")
    g_max = max(np.abs(g).max() for g in ref.values()) / (1 - b1)
    for name in ref:
        g_ref, g = ref[name] / (1 - b1), got[name] / (1 - b1)
        np.testing.assert_allclose(g, g_ref, atol=2e-4 * np.abs(g_ref).max() + 1e-6 * g_max,
                                   rtol=2e-4, err_msg=name)


@pytest.fixture(scope="module")
def multiscale_run(tmp_path_factory):
    """train(multi_scale=True) of vil-det-tiny at 160 px, 2 epochs of 2
    steps (8 images, batch 2, accumulate 2), recording each forward's size."""
    from test_torch_trainer import tiny_set, trainer

    root = tmp_path_factory.mktemp("multiscale")
    t = trainer(tiny_set(root), root, "ms", multi_scale=True, seed=3)
    sizes = []
    loss_fn = steps.detect_loss

    def recording(model, batch, nc=80, generator=None, imgsz_out=None):
        sizes.append(imgsz_out or batch["img"].shape[1])
        return loss_fn(model, batch, nc, generator, imgsz_out)

    out = io.StringIO()
    steps.detect_loss = recording
    try:
        with contextlib.redirect_stdout(out):
            metrics = t.train()
    finally:
        steps.detect_loss = loss_fn
    return dict(trainer=t, sizes=sizes, stdout=out.getvalue(), metrics=metrics)


def test_multiscale_train_runs_and_prints_buckets(multiscale_run):
    t = multiscale_run["trainer"]
    assert "multi-scale buckets: [128, 160, 192]" in multiscale_run["stdout"]
    assert len(t.buckets) == 4 and all(np.isfinite(float(m["loss"])) for m in t.losses)
    assert multiscale_run["sizes"] == [b for b in t.buckets for _ in range(t.accumulate)]
    assert (t.wdir / "last.pt").is_file()


def test_multiscale_bucket_sequence_is_jax_draw(multiscale_run):
    """JAX's trainer draws each step's bucket with
    random.Random(seed * 1000 + epoch).choice over its bucket dict's keys."""
    keys = sorted({max(32, round(160 * s / 32) * 32) for s in (0.8, 1.0, 1.2)})
    want = []
    for epoch in range(2):
        r = random.Random(3 * 1000 + epoch)
        want += [r.choice(keys) for _ in range(2)]
    assert multiscale_run["trainer"].buckets == want
