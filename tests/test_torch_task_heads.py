"""The task heads (Segment, Pose, OBB, Classify) held against the JAX package.

Each tiny task config (``vil-det-tiny-{seg,pose,obb}.yaml``,
``vil-cls-tiny.yaml``) at 160 px, batch 2, float32: the port's weights
from seed 0 go to JAX's variable tree (shapes from ``jax.eval_shape``, so
no JAX init is compiled), the ifgates are perturbed there as in
``test_torch_model.py``, and the tree comes back through
``jax_variables_to_state_dict`` under a strict load.  Inputs are numpy
from a seed.

Tolerances.  The boxes and class scores are held as the detector's are
(``test_torch_model.py``: atol 1 px / rtol 1e-3 and 3e-3): this random
network with active cells amplifies float32 rounding through its depth.
The extras go through the same depth: on these inputs the mask
coefficients, prototypes and angle of JAX and the port differ by at most
1.3e-2 (their values reach ~3), the keypoints by 0.6 px (of ~160) and the
class probabilities by 2e-5; they are held to atol 3e-2, 1.5 px and 1e-4.
A wiring fault (a flipped transposed-conv kernel, a swapped tower, a
wrong decode) moves them by O(1).

Also: Proto's transposed conv alone against flax's (and an unflipped
kernel fails), the heads at vil-det-192's width against ``jax.eval_shape``
of JAX's builder on the same dicts, ``kpt_shape`` rewriting the Pose row,
and the fused build of a Segment or Classify model, which JAX's fused model
cannot run and the port refuses.
"""

import copy
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_model import BOX_TOL, CFG, SCORE_ATOL, perturb_ifgates
from xlstm_yolo_tpu.nn.tasks import build_detection_model as jax_build
from xlstm_yolo_tpu.utils.fuse import fuse_variables
from xlstm_yolo_tpu_torch.nn.layers import ConvTranspose
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
from xlstm_yolo_tpu_torch.utils.convert import _leaves, jax_path_to_name, jax_variables_to_state_dict

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

PORT_CFG = Path(__file__).resolve().parents[1] / "xlstm_yolo_tpu_torch" / "cfg" / "models"
TASK_CFGS = ["vil-det-tiny-seg.yaml", "vil-det-tiny-pose.yaml", "vil-det-tiny-obb.yaml",
             "vil-cls-tiny.yaml"]
EXTRA_ATOL = 3e-2  # mask coefficients, prototypes, angle
KPT_ATOL = 1.5     # px
PROB_ATOL = 1e-4


def to_jax_layout(t: np.ndarray, kind: str) -> np.ndarray:
    """Inverse of ``jax_variables_to_state_dict``'s layout rules."""
    if kind == "transposed":
        return t.transpose(2, 3, 0, 1)[::-1, ::-1]
    if kind == "kernel":
        return {2: lambda a: a.T, 3: lambda a: a.transpose(2, 1, 0),
                4: lambda a: a.transpose(2, 3, 1, 0)}.get(t.ndim, lambda a: a)(t)
    return t


def port_to_jax(model: torch.nn.Module, shapes) -> dict:
    """The port model's state dict as JAX's variable tree of ``shapes``."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    def fill(path, leaf):
        name, kind = jax_path_to_name(tuple(str(getattr(p, "key", p)) for p in path))
        out = np.ascontiguousarray(to_jax_layout(sd[name], kind))
        assert out.shape == leaf.shape, (name, out.shape, leaf.shape)
        return out

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_shapes(cfg, size: int, **kw):
    jm, d = jax_build(cfg, **kw)
    return jm, d, jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                 jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))


@pytest.fixture(scope="module", params=TASK_CFGS)
def pair(request):
    """(cfg, JAX model, JAX variables, port model on the same weights, input,
    JAX output, port output)."""
    cfg = request.param
    rng = np.random.default_rng(0)
    model, _ = build_detection_model(cfg, device="cpu", compute_dtype=torch.float32)
    jm, d, shapes = jax_shapes(CFG / cfg, 160)
    variables = perturb_ifgates(port_to_jax(model, shapes), rng)
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    x = rng.normal(0.45, 0.2, (2, 160, 160, 3)).astype(np.float32)
    yj = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        yp = model(torch.from_numpy(x))
    return dict(cfg=cfg, jm=jm, variables=variables, model=model, x=x,
                yj=jax.tree.map(np.asarray, yj), yp=yp)


def test_configs_are_byte_copies():
    for cfg in TASK_CFGS:
        assert (PORT_CFG / cfg).read_bytes() == (CFG / cfg).read_bytes(), cfg


def test_task_forward_matches_jax(pair):
    cfg, yj, yp = pair["cfg"], pair["yj"], pair["yp"]
    if cfg == "vil-cls-tiny.yaml":
        probs, logits = yp
        assert probs.dtype == logits.dtype == torch.float32
        np.testing.assert_allclose(probs.numpy(), yj[0], atol=PROB_ATOL)
        np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)
        assert (probs.argmax(-1).numpy() == yj[0].argmax(-1)).all()
        return
    y, aux = yp[0].numpy(), {k: v for k, v in yp[1].items() if k != "one2many"}
    rj, auxj = yj
    assert y.shape == rj.shape
    nc = 80
    np.testing.assert_allclose(y[..., :4], rj[..., :4], **BOX_TOL)
    np.testing.assert_allclose(y[..., 4:4 + nc], rj[..., 4:4 + nc], atol=SCORE_ATOL)
    extra, extra_j = y[..., 4 + nc:], rj[..., 4 + nc:]
    if "kpts" in aux:
        dec, dec_j = extra.reshape(2, -1, 17, 3), extra_j.reshape(2, -1, 17, 3)
        np.testing.assert_allclose(dec[..., :2], dec_j[..., :2], atol=KPT_ATOL)
        np.testing.assert_allclose(dec[..., 2], dec_j[..., 2], atol=SCORE_ATOL)
    else:
        np.testing.assert_allclose(extra, extra_j, atol=EXTRA_ATOL)
    assert set(aux) == set(auxj) - {"one2many"}
    for k, v in aux.items():
        assert v.dtype == torch.float32 and v.shape == auxj[k].shape, k
        np.testing.assert_allclose(v.numpy(), auxj[k], atol=EXTRA_ATOL if k != "kpts" else 0.1,
                                   err_msg=k)
    if "angle" in aux:
        a = aux["angle"].numpy()
        assert (a >= -np.pi / 4).all() and (a <= 3 * np.pi / 4).all()


def flax_convtranspose(c: int, x: np.ndarray, seed: int):
    m = fnn.ConvTranspose(c, (2, 2), strides=(2, 2))
    v = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    v = jax.tree.map(lambda a: np.asarray(a) + 0.1, v)  # a non-zero bias too
    return m, v


@pytest.mark.parametrize("flip", [True, False])
def test_proto_transposed_conv_against_flax(flip):
    """The converter's flip: the unflipped kernel (a mutation) must miss."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    m, v = flax_convtranspose(4, x, 0)
    want = np.asarray(m.apply(v, jnp.asarray(x)))
    sd = jax_variables_to_state_dict({"params": {"proto": {"upsample": v["params"]}}})
    assert set(sd) == {"proto.upsample.weight", "proto.upsample.bias"}
    w = sd["proto.upsample.weight"]
    if not flip:
        w = w.flip(2, 3)
    layer = ConvTranspose(6, 4, 2)
    layer.load_state_dict({"weight": w, "bias": sd["proto.upsample.bias"]}, strict=True)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 10, 14, 4)
    err = np.abs(got - want).max()
    assert (err < 1e-5) if flip else (err > 0.1), err


def test_transposed_conv_promotes_bfloat16_like_flax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 3, 3, 6)).astype(np.float32)
    layer = ConvTranspose(6, 4, 2)
    torch.nn.init.normal_(layer.weight)
    with torch.no_grad():
        y = layer(torch.from_numpy(x).bfloat16())
    assert y.dtype == torch.float32


def flagship_dicts() -> dict:
    """vil-det-192's width and depth with each task head (the chip smoke's)."""
    base = yaml.safe_load((CFG / "vil-det-192.yaml").read_text())
    out = {}
    for name, row in (("segment", [[21, 24, 27, 30], 1, "Segment", ["nc", 32, 256]]),
                      ("pose", [[21, 24, 27, 30], 1, "Pose", ["nc", [17, 3]]]),
                      ("obb", [[21, 24, 27, 30], 1, "OBB", ["nc", 1]])):
        d = copy.deepcopy(base)
        d["head"][-1] = row
        out[name] = d
    d = copy.deepcopy(base)
    d["head"] = [[8, 1, "SequenceToImage", [[10, 10]]], [-1, 1, "Classify", ["nc"]]]
    d["backbone"] = d["backbone"][:9]
    out["classify"] = d
    return out


@pytest.mark.parametrize("task", ["segment", "pose", "obb", "classify"])
def test_flagship_width_heads_take_jax_shapes(task):
    """The smoke's full-width task models: every parameter name and shape of
    JAX's builder (``jax.eval_shape``: nothing is computed) loads strictly."""
    d = flagship_dicts()[task]
    model, _ = build_detection_model(copy.deepcopy(d), device="cpu")
    _, _, shapes = jax_shapes(copy.deepcopy(d), 640)
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = jax_variables_to_state_dict(variables)
    own = model.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == own[k].shape for k in own)
    cells = sum(type(m).__name__ == "MatrixLSTMCell" for m in model.modules())
    assert cells == (8 if task == "classify" else 20)


def test_kpt_shape_rewrites_the_pose_row():
    model, d = build_detection_model("vil-det-tiny-pose.yaml", device="cpu", kpt_shape=(4, 3))
    jm, jd = jax_build(CFG / "vil-det-tiny-pose.yaml", kpt_shape=(4, 3))
    assert d["head"][-1] == jd["head"][-1] == [[15, 18, 21], 1, "Pose", ["nc", [4, 3]]]
    assert model.model[-1].kpt_shape == (4, 3)
    with torch.no_grad():
        y, aux = model(torch.zeros(1, 160, 160, 3))
    assert y.shape == (1, 525, 4 + 80 + 12) and aux["kpts"].shape == (1, 525, 12)


@pytest.mark.parametrize("cfg", ["vil-det-tiny-seg.yaml", "vil-cls-tiny.yaml"])
def test_fused_segment_and_classify_refused_as_jax_cannot_run_them(cfg):
    """JAX folds every BatchNorm (``fuse_variables``) but builds Proto and
    Classify without ``fused``: its fused model cannot take the folded
    variables.  The port raises before building anything."""
    jm, _, shapes = jax_shapes(CFG / cfg, 160)
    jf, _ = jax_build(CFG / cfg, fused=True)
    variables = jax.tree.map(lambda s: np.ones(s.shape, np.float32), shapes)
    fused = fuse_variables(variables)
    with pytest.raises(Exception, match="batch_stats.*(proto/cv1|conv)/bn"):
        jax.eval_shape(jf.apply, fused, jax.ShapeDtypeStruct((1, 160, 160, 3), jnp.float32))
    with pytest.raises(ValueError, match="fused=True"):
        build_detection_model(cfg, device="cpu", fused=True)


@pytest.mark.parametrize("cfg", ["vil-det-tiny-pose.yaml", "vil-det-tiny-obb.yaml"])
def test_fused_pose_and_obb_match_unfused(cfg):
    """Pose and OBB fold as the detector does: the fused model's output
    equals the unfused one's (float32, to rounding)."""
    from xlstm_yolo_tpu_torch.utils.fuse import fuse_state_dict

    model, _ = build_detection_model(cfg, device="cpu", compute_dtype=torch.float32)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    fused, _ = build_detection_model(cfg, device="cpu", compute_dtype=torch.float32, fused=True)
    fused.load_state_dict(fuse_state_dict(model.state_dict()), strict=True)
    x = torch.rand(1, 160, 160, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        a, b = model(x)[0], fused(x)[0]
    torch.testing.assert_close(b, a, atol=1e-3, rtol=1e-3)


def test_leaf_walk_covers_every_jax_leaf(pair):
    """Every JAX leaf of the task models names a distinct port tensor."""
    names = [jax_path_to_name(p)[0] for p, _ in _leaves(pair["variables"])]
    assert len(names) == len(set(names)) == len(pair["model"].state_dict())
