"""The two larger detectors, ``vil-det-256`` (dim 256, cell width 512, 8
heads of 64, FFN width 704) and ``vil-det-384`` (dim 384, cell width 768, 6
heads of 128, FFN width 1024), the twins of the reference's
``640-base256.yaml`` and ``640-base384.yaml``, held against the JAX
package: the YAMLs, the models the port builds from them, JAX's
parameters under a strict load, and a ViLBlockPair and a ViLFusionBlock at
vil-det-384's widths, forward and gradient.  Also: every mLSTM kernel
wrapper refuses a head dim its kernels do not take.

No full-size JAX program is traced or run here: JAX's parameter shapes
come from ``jax.eval_shape`` of its init, filled from a numpy seed.  The
full vil-det-384 forward against JAX at 640 px is ``slow``.

Tolerances.  Forward in float32, atol = rtol = 1e-4 of the output's largest
|value| (float32 sums in another order through two ViL layers).
Gradients: the JAX side runs the v1 route with float32 products, whose
Pallas VJP holds the denominator max(|.|, 1) constant, as the port's
kernels do on every route; each leaf within 1e-4 of its largest |g| (rtol
1e-4) plus 1e-6 of the largest |g| of all leaves (the biases just ahead of
a BatchNorm have a true gradient of 0 and hold only rounding, as in
``test_torch_train_step.py``).  The port runs both its default v2 route
and the v1 route: the function and its stop-gradient do not depend on the
chunking.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_layers import randomize
from test_torch_model import CFG, assert_close_to_float64_arbiter, jax_detector, port_detector
from test_torch_model import use_float32_products
from test_torch_train_step import leaves_by_name
from xlstm_yolo_tpu.nn import blocks as jb
from xlstm_yolo_tpu.nn import layers as jl
from xlstm_yolo_tpu.nn.tasks import build_detection_model as jax_build
from xlstm_yolo_tpu_torch.nn import blocks as tb
from xlstm_yolo_tpu_torch.nn import layers as tl
from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
from xlstm_yolo_tpu_torch.ops import backend
from xlstm_yolo_tpu_torch.ops import chunkwise as v1
from xlstm_yolo_tpu_torch.ops import chunkwise_exp as exp
from xlstm_yolo_tpu_torch.ops import chunkwise_v2, step
from xlstm_yolo_tpu_torch.ops import parallel as par
from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

PORT_CFG = Path(__file__).resolve().parents[1] / "xlstm_yolo_tpu_torch" / "cfg" / "models"
WIDE = {  # YAML -> (dim, cell width H, NH, DH, FFN width U)
    "vil-det-256.yaml": (256, 512, 8, 64, 704),
    "vil-det-384.yaml": (384, 768, 6, 128, 1024),
}
V1 = backend.V1_KERNEL
DIM, QKV = 384, 128  # vil-det-384's widths
REL = 1e-4
BN_FLOOR = 1e-6  # of the largest |g|: the biases ahead of a BatchNorm hold only rounding


@pytest.mark.parametrize("cfg", list(WIDE))
def test_yaml_is_byte_identical_to_jax(cfg):
    assert (PORT_CFG / cfg).read_bytes() == (CFG / cfg).read_bytes()


def jax_param_shapes(cfg):
    """JAX's variables as ``jax.ShapeDtypeStruct`` leaves, from
    ``jax.eval_shape`` of its init at the YAML's image size (nothing is
    computed)."""
    jm, d = jax_build(CFG / cfg)
    size = int(d["imgsz"])
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))


@pytest.mark.parametrize("cfg", list(WIDE))
def test_model_builds_and_takes_jax_parameters_strictly(cfg):
    """The port builds the model at the published widths, and JAX's
    variables (shapes from ``jax.eval_shape``, values from a numpy seed)
    load into it with ``strict=True``, every tensor where it belongs."""
    dim, H, NH, DH, U = WIDE[cfg]
    model, d = build_detection_model(cfg, device="cpu")
    assert int(d["imgsz"]) == 640
    cells = [m for m in model.modules() if isinstance(m, MatrixLSTMCell)]
    ffns = [m for m in model.modules() if isinstance(m, tl.FeedForward)]
    assert len(cells) == 20
    assert {(c.num_heads, c.outnorm.head_dim) for c in cells} == {(NH, DH)}
    assert {f.up for f in ffns} == {U}
    assert {tuple(f.proj_down.weight.shape) for f in ffns} == {(dim, U)}
    assert {c.ifgate.weight.shape[1] for c in cells} == {3 * H}

    rng = np.random.default_rng(len(cfg))
    shapes = jax_param_shapes(cfg)
    variables = jax.tree.map(
        lambda s: rng.normal(0, 0.02, s.shape).astype(np.float32), shapes)
    sd = jax_variables_to_state_dict(variables)
    own = model.state_dict()
    assert set(sd) == set(own)
    for name, t in own.items():
        assert sd[name].shape == t.shape, name
    model.load_state_dict(sd, strict=True)
    name = next(n for n in sd if n.endswith("mlstm_cell.ifgate.weight"))
    assert torch.equal(model.state_dict()[name], sd[name])


def wide_module(kind, training, chunkwise_kernel=None):
    """(JAX module, port module) of ``kind`` at vil-det-384's widths, seqlens
    (10, 10), chunk 64 (the YAML's at that grid)."""
    kw = dict(seqlens=(10, 10), qkv_block_size=QKV, chunk_size=64)
    if chunkwise_kernel is not None:
        kw["chunkwise_kernel"] = chunkwise_kernel
    if kind == "ViLBlockPair":
        return jl.ViLBlockPair(dim=DIM, training=training, **kw), tl.ViLBlockPair(DIM, **kw)
    return (jb.ViLFusionBlock(c1=2 * DIM, dim=DIM, training=training, **kw),
            tb.ViLFusionBlock(2 * DIM, DIM, **kw))


def wide_input(kind, rng):
    shape = (2, 100, DIM) if kind == "ViLBlockPair" else (2, 10, 10, 2 * DIM)
    return rng.normal(size=shape).astype(np.float32)


def assert_rel_close(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    np.testing.assert_allclose(got, ref, atol=REL * np.abs(ref).max(), rtol=REL, err_msg=name)


@pytest.mark.parametrize("kind", ["ViLBlockPair", "ViLFusionBlock"])
def test_wide_block_forward_matches_jax(kind):
    """In eval, every weight ~ 0.05 N(0, 1) (BatchNorm statistics random):
    the port's default route against JAX's default."""
    rng = np.random.default_rng(31)
    x = wide_input(kind, rng)
    jm, pm = wide_module(kind, training=False)
    variables = randomize(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                           jnp.asarray(x))), rng, scale=0.05)
    y_ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    pm.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    with torch.no_grad():
        y = pm.eval()(torch.from_numpy(x)).numpy()
    assert_rel_close(y, y_ref, "y")


@pytest.fixture(scope="module", params=["ViLBlockPair", "ViLFusionBlock"])
def wide_jax_grads(request):
    """JAX's training forward and the gradients of sum(y * w) with respect
    to every parameter and the input, on the v1 route with float32
    products (BatchNorm on batch statistics), and what the port needs to
    repeat it."""
    kind = request.param
    rng = np.random.default_rng(32)
    x = wide_input(kind, rng)
    with pytest.MonkeyPatch.context() as mp:
        use_float32_products(mp)
        jm, _ = wide_module(kind, training=True, chunkwise_kernel=V1)
        variables = randomize(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                               jnp.asarray(x))), rng,
                              scale=0.05)
        w = rng.normal(size=x.shape[:-1] + (DIM,)).astype(np.float32)

        def loss(params, xx):
            y, _ = jm.apply({**variables, "params": params}, xx, mutable=["batch_stats"])
            return jnp.sum(y * w), y

        (_, y), (g, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            variables["params"], jnp.asarray(x))
    return dict(kind=kind, x=x, w=w, variables=variables, y=np.asarray(y),
                grads={"x": np.asarray(gx), **leaves_by_name(g)})


@pytest.mark.parametrize("route", ["v2", "v1"])
def test_wide_block_gradients_match_jax(wide_jax_grads, route, monkeypatch):
    """The port in training on its default v2 route (the train forward and
    fused backward; the epilogue and FFN backwards) and on the v1 route
    with float32 products, against ``wide_jax_grads``."""
    ref = wide_jax_grads
    kind = ref["kind"]
    if route == "v1":
        use_float32_products(monkeypatch)
    _, pm = wide_module(kind, training=True, chunkwise_kernel=V1 if route == "v1" else None)
    pm.load_state_dict(jax_variables_to_state_dict(ref["variables"]), strict=True)
    pm.train()
    xt = torch.from_numpy(ref["x"]).requires_grad_()
    y = pm(xt)
    params = [(n, p) for n, p in pm.named_parameters()]
    g = torch.autograd.grad((y * torch.from_numpy(ref["w"])).sum(),
                            [xt, *(p for _, p in params)])
    assert_rel_close(y.detach().numpy(), ref["y"], "y")
    got = {"x": g[0].numpy(), **{n: t.numpy() for (n, _), t in zip(params, g[1:])}}
    assert set(got) == set(ref["grads"])
    top = max(np.abs(r).max() for r in ref["grads"].values())
    for name, r in ref["grads"].items():
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], r, rtol=REL,
                                   atol=REL * np.abs(r).max() + BN_FLOOR * top, err_msg=name)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def wrapper_calls(DH):
    """name -> a call of each mLSTM kernel wrapper on meta tensors of head
    dim DH (valid in every other respect), so each reaches its kernel
    checks."""
    B, NH, S, L = 1, 2, 64, 64
    H = NH * DH
    bsh, gates = meta(B, S, H), meta(B, S, NH)
    c, n = meta(B, NH, DH, DH), meta(B, NH, DH)
    q4, g3 = meta(B, NH, S, DH), meta(B, NH, S)
    st = meta(B, NH, 1, DH, DH)
    mrow = meta(B, NH, 1, 2)
    return {
        "v2 inference": lambda: chunkwise_v2.mlstm_siging_chunkwise_fw(
            bsh, bsh, bsh, gates, gates, NH),
        "v2 fused LayerNorm": lambda: chunkwise_v2.mlstm_siging_chunkwise_fw_ln(
            bsh, bsh, bsh, gates, gates, NH, meta(H)),
        "v2 train": lambda: chunkwise_v2.mlstm_siging_chunkwise_fw_train(
            bsh, bsh, bsh, gates, gates, NH),
        "v2 backward": lambda: chunkwise_v2.mlstm_siging_chunkwise_bw(
            bsh, bsh, bsh, gates, gates, NH, meta(B, 1, NH, DH, DH), meta(B, 1, NH, L), bsh),
        "v1 forward": lambda: v1.chunkwise_fw(q4, q4, q4, g3, g3, chunk_size=L),
        "v1 dC scan": lambda: v1.chunkwise_bw_dc(q4, g3, q4, g3, chunk_size=L),
        "v1 dq/dk/dv": lambda: v1.chunkwise_bw_dqkv(q4, q4, q4, g3, g3, st, g3, q4, st,
                                                    chunk_size=L),
        "exp forward": lambda: exp.chunkwise_exp_fw(q4, q4, q4, g3, g3, chunk_size=L),
        "exp dC scan": lambda: exp.chunkwise_exp_bw_dc(q4, g3, q4, g3, g3, mrow,
                                                       chunk_size=L),
        "exp dq/dk/dv": lambda: exp.chunkwise_exp_bw_dqkv(q4, q4, q4, g3, g3, st, g3, g3, mrow,
                                                          q4, st, chunk_size=L),
        "quadratic forward": lambda: par.parallel_fw(q4, q4, q4, g3, g3),
        "quadratic dq": lambda: par.parallel_bw_dq(q4, q4, q4, g3, g3, g3, q4),
        "quadratic dk/dv": lambda: par.parallel_bw_dkv(q4, q4, q4, g3, g3, g3, q4),
        "step": lambda: step.mlstm_siging_step_kernel(
            meta(B, NH, DH), meta(B, NH, DH), meta(B, NH, DH), meta(B, NH), meta(B, NH), c, n),
    }


@pytest.mark.parametrize("name", list(wrapper_calls(48)))
def test_every_wrapper_refuses_head_dim_48(name):
    """DH 48 raises, naming the head dims the kernels take; DH 64 and 128
    pass the head-dim check (and stop at the device: meta is no card)."""
    with pytest.raises(ValueError, match=r"head dim 48 not supported by the kernel "
                                         r"\(16, 32, 64, 128\)"):
        wrapper_calls(48)[name]()
    for DH in (64, 128):
        with pytest.raises(ValueError, match="unsupported device"):
            wrapper_calls(DH)[name]()


@pytest.mark.slow
def test_vil_det_384_decode_only_matches_jax():
    """vil-det-384 at full width and depth, 640 px, batch 1, float32 on the
    CPU: the port's decode-only forward against the JAX one, with the
    port's float64 forward as the arbiter (see ``test_torch_model.py``)."""
    jm_dec, _, variables, x = jax_detector("vil-det-384.yaml", batch=1)
    y_ref = np.asarray(jax.jit(jm_dec.apply)(variables, jnp.asarray(x))[0])
    assert y_ref.shape == (1, 80 * 80 + 40 * 40 + 20 * 20 + 10 * 10, 84)
    model = port_detector("vil-det-384.yaml", variables, decode_only=True)
    assert_close_to_float64_arbiter(y_ref, model, x)
