"""``vil-det-tiny`` on the exp route (``chunkwise_kernel=
"chunkwise--pallas_xl_chunk"``: the exponential input gate with the max
stabilizer) held against the JAX package's detector on the same route.

The JAX model is initialised on CPU, its ifgates perturbed (kernel
N(0, 0.01), input-gate bias U(-3, 1): every cell far from inert), and its
variables carried into the port with a strict load; inputs from numpy with
a seed, float32.  The JAX route runs its Pallas kernels in interpret mode.

As on the v1 route (``test_torch_model.py``), the route rounds the operands
of every cell product to bfloat16, in a float32 model too, and this random
network amplifies the resulting one-step flips through its depth.  So the
route is held two ways: as it runs, against the port's float64 forward
only; and with float32 products in both registries (float64 in the port's
float64 arbiter), at the tolerances of ``test_torch_model.py`` for the
decode-only output.  The gradients of one E2E-loss step are held against
the port's float64 gradient (see that test), and a ``ViLBlockPair`` on the
route is held tightly against JAX's gradient.  In eval both wrappers run
the recurrent tails through ``sequence--native`` and drop m there (ROADMAP
Queue 3), which the port mirrors.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import (
    BOX_TOL,
    CFG,
    SCORE_ATOL,
    assert_close_to_float64_arbiter,
    jax_detector,
)
from test_torch_layers import randomize
from test_torch_train_step import leaves_by_name, make_batch
from xlstm_yolo_tpu.nn import layers as jl
from xlstm_yolo_tpu.nn.tasks import build_detection_model as jax_build
from xlstm_yolo_tpu.ops import backend as jax_backend
from xlstm_yolo_tpu.ops.mlstm_chunkwise import mlstm_chunkwise_stabilized as jax_stabilized
from xlstm_yolo_tpu.ops.pallas.chunkwise_exp import mlstm_chunkwise_exp_pallas
from xlstm_yolo_tpu.utils.loss import e2e_detect_loss as jax_e2e_loss
from xlstm_yolo_tpu_torch.engine import steps
from xlstm_yolo_tpu_torch.nn import layers as tl
from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
from xlstm_yolo_tpu_torch.ops import backend
from xlstm_yolo_tpu_torch.ops import chunkwise_exp as exp
from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict

EXP = "chunkwise--pallas_xl_chunk"
EXP_GRAD_REL = 0.1    # JAX's float32 model gradient against the port's float64 one
PORT_GRAD_REL = 1e-3  # the port's float32 model gradient against its float64 one


def use_float32_products(mp):
    """Both registries' exp entry with float32 products (float64 in the
    port's float64 arbiter), for the duration of ``mp``."""
    jax_backend.get_mlstm_kernel(EXP)  # registers the Pallas kernels first
    mp.setitem(jax_backend._CHUNKWISE_REGISTRY, "pallas_xl_chunk",
               functools.partial(mlstm_chunkwise_exp_pallas, compute_dtype=jnp.float32))

    def port_exp(q, *args, **kw):
        cd = torch.float64 if q.dtype == torch.float64 else torch.float32
        return exp.mlstm_chunkwise_exp(q, *args, compute_dtype=cd, **kw)
    mp.setitem(backend._REGISTRY["chunkwise"], "pallas_xl_chunk", port_exp)


def port_model(variables, **kw):
    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu", chunkwise_kernel=EXP, **kw)
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def tiny_exp():
    """JAX's exp route on perturbed tiny variables: the decode-only output
    as the route runs, and with float32 products the decode-only output and
    the loss and gradients of one E2E-loss step."""
    _, _, variables, x = jax_detector("vil-det-tiny.yaml", batch=2)
    cfg, xj = CFG / "vil-det-tiny.yaml", jnp.asarray(x)
    out = {"variables": variables, "x": x,
           "y_route": np.asarray(jax.jit(jax_build(cfg, decode_only=True, chunkwise_kernel=EXP)[0]
                                         .apply)(variables, xj)[0])}
    batch = make_batch(1)
    with pytest.MonkeyPatch.context() as mp:
        use_float32_products(mp)
        jm_dec, _ = jax_build(cfg, decode_only=True, chunkwise_kernel=EXP)
        out["y_f32"] = np.asarray(jax.jit(jm_dec.apply)(variables, xj)[0])
        value, grads = jax_loss_and_grads(variables, batch)
    return dict(out, batch=batch, loss=value, grads=grads)


def jax_loss_and_grads(variables, batch):
    """The loss and the gradients by leaf name of one E2E-loss step of JAX's
    training model on the exp route, with its registry as it stands."""
    jm, _ = jax_build(CFG / "vil-det-tiny.yaml", training=True, chunkwise_kernel=EXP)
    stats = variables["batch_stats"]

    def loss(params, b):
        img = b["img"].astype(jnp.float32) / 255.0
        maps, _ = jm.apply({"params": params, "batch_stats": stats}, img,
                           mutable=["batch_stats"], rngs={"droppath": jax.random.PRNGKey(3)})
        strides = [img.shape[1] / f.shape[1] for f in maps["one2many"]]
        return jax_e2e_loss(maps, b["cls"], b["bboxes"], b["mask"], strides, nc=80)[0]

    value, grads = jax.jit(jax.value_and_grad(loss))(
        variables["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    return float(value), leaves_by_name(grads)


def test_tiny_exp_route_strict_load_and_decode_against_float64_arbiter(tiny_exp):
    """The route as it runs (bfloat16 products): the strict load of JAX's
    variables, every cell on the route, and JAX's output no further from the
    port's float64 forward than twice the port's float32 one."""
    model = port_model(tiny_exp["variables"], decode_only=True)
    cells = [m for m in model.modules() if isinstance(m, MatrixLSTMCell)]
    assert len(cells) == 14 and all(m.chunkwise_kernel == EXP for m in cells)
    assert_close_to_float64_arbiter(tiny_exp["y_route"], model, tiny_exp["x"])


def test_tiny_exp_route_decode_only_matches_jax_with_float32_products(tiny_exp, monkeypatch):
    use_float32_products(monkeypatch)
    calls = []
    fw = exp.chunkwise_exp_fw

    def recording_fw(*args, **kw):
        calls.append(kw["save_states"])
        return fw(*args, **kw)
    monkeypatch.setattr(exp, "chunkwise_exp_fw", recording_fw)
    model = port_model(tiny_exp["variables"], decode_only=True)
    with torch.no_grad():
        y = model(torch.from_numpy(tiny_exp["x"]))[0].numpy()
    assert len(calls) == 20 and not any(calls)  # the segments, predict variant
    y_ref = tiny_exp["y_f32"]
    np.testing.assert_allclose(y[..., :4], y_ref[..., :4], **BOX_TOL)
    np.testing.assert_allclose(y[..., 4:], y_ref[..., 4:], atol=SCORE_ATOL)
    assert_close_to_float64_arbiter(y_ref, model, tiny_exp["x"])


def test_tiny_exp_route_gradients_match_jax_with_float32_products(tiny_exp, monkeypatch):
    """One E2E-loss step of the training model on the exp route, float32
    products on both sides (float64 in the port's float64 step): the JAX
    gradient goes through the Pallas custom VJP, which holds the
    stabilizers and the denominator constant, as the port's Function does
    (the ViLBlockPair test below holds the two to 1e-4).

    The port's float64 gradient is the arbiter, per leaf relative to its
    largest |g| (floored at 1e-3 of the largest |g| of all leaves: the
    biases ahead of a BatchNorm have a true gradient of 0).  The port's
    float32 gradient must be within PORT_GRAD_REL of it.  JAX's float32
    gradient of this network is sensitive on this route: two forms of the
    same function in JAX's registry disagree by about as much as either is
    from the port's float64 gradient (the slow test below prints the
    three distances), so JAX's is held within EXP_GRAD_REL: a wiring fault
    (a dropped gate gradient or term) moves leaves by O(1).  Both largest
    distances are printed.  Loss rtol 1e-4."""
    use_float32_products(monkeypatch)
    m_comb = []
    fw = exp.chunkwise_exp_fw

    def recording_fw(*args, **kw):
        out = fw(*args, **kw)
        m_comb.append(out[2])
        return out
    monkeypatch.setattr(exp, "chunkwise_exp_fw", recording_fw)
    model = port_model(tiny_exp["variables"], training=True)
    batch = {k: torch.from_numpy(v) for k, v in tiny_exp["batch"].items()}
    loss, _ = steps.detect_loss(model, batch)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    assert len(m_comb) == 14  # one cell call per ViL layer, each padded to whole chunks
    assert float(torch.cat([m.flatten() for m in m_comb]).abs().max()) > 0.5  # stabilized
    model64 = copy.deepcopy(model).double()
    loss64, _ = steps.detect_loss(model64, dict(batch, bboxes=batch["bboxes"].double()))
    g64 = dict(zip(names, torch.autograd.grad(loss64, list(model64.parameters()))))
    np.testing.assert_allclose(loss.item(), tiny_exp["loss"], rtol=1e-4)
    np.testing.assert_allclose(loss64.item(), tiny_exp["loss"], rtol=1e-4)
    ref = tiny_exp["grads"]
    assert set(ref) == set(grads)
    g64 = {name: g.numpy() for name, g in g64.items()}
    port_errs = distances_to(g64, {name: g.numpy() for name, g in grads.items()})
    jax_errs = distances_to(g64, ref)
    for name in ref:
        assert port_errs[name] <= PORT_GRAD_REL, (name, port_errs[name])
        assert jax_errs[name] <= EXP_GRAD_REL, (name, jax_errs[name], port_errs[name])
    print(f"largest distance from the port's float64 gradient: port float32 "
          f"{max(port_errs.values()):.3g}, JAX float32 {max(jax_errs.values()):.3g}")


def distances_to(g64, grads):
    """Per leaf, max |g - g64| over the leaf's largest |g64|, floored at 1e-3
    of the largest |g64| of all leaves."""
    top = max(np.abs(g).max() for g in g64.values())
    return {name: np.abs(grads[name] - r).max() / max(np.abs(r).max(), 1e-3 * top)
            for name, r in g64.items()}


@pytest.mark.slow
def test_tiny_exp_route_jax_gradient_forms_disagree(tiny_exp, monkeypatch):
    """The sensitivity that sets EXP_GRAD_REL: JAX's float32 gradient of one
    E2E-loss step through its exp Pallas kernels and through
    ``mlstm_chunkwise_stabilized(stopgrad_norm=True)`` (the same function,
    float32 products), each against the port's float64 gradient and against
    each other; the three largest distances are printed.  Every distance is
    below EXP_GRAD_REL, and the two JAX forms are further apart than
    PORT_GRAD_REL, the bound the port's float32 gradient meets."""
    use_float32_products(monkeypatch)
    monkeypatch.setitem(jax_backend._CHUNKWISE_REGISTRY, "pallas_xl_chunk",
                        functools.partial(jax_stabilized, stopgrad_norm=True))
    _, grads_native = jax_loss_and_grads(tiny_exp["variables"], tiny_exp["batch"])
    model = port_model(tiny_exp["variables"], training=True).double()
    batch = {k: torch.from_numpy(v) for k, v in tiny_exp["batch"].items()}
    loss64, _ = steps.detect_loss(model, dict(batch, bboxes=batch["bboxes"].double()))
    g64 = dict(zip([n for n, _ in model.named_parameters()],
                   (g.numpy() for g in torch.autograd.grad(loss64, list(model.parameters())))))
    pallas = max(distances_to(g64, tiny_exp["grads"]).values())
    native = max(distances_to(g64, grads_native).values())
    apart = max(distances_to(grads_native, tiny_exp["grads"]).values())
    print(f"JAX float32 gradient vs the port's float64: Pallas kernels {pallas:.3g}, "
          f"stabilized chunkwise {native:.3g}; the two JAX forms apart {apart:.3g}")
    assert max(pallas, native, apart) <= EXP_GRAD_REL
    assert apart > PORT_GRAD_REL


def test_vil_block_pair_gradients_match_jax_on_the_exp_route(monkeypatch):
    """A ViLBlockPair in training on the exp route (S = 36 zero-padded to
    three chunks of 16, 4 heads of 16, every parameter ~ 0.2 N(0, 1), so the
    input gates range widely and m moves), float32 products in both
    registries: the output and the gradients of sum(y * w) with respect to
    every parameter and the input, against jax.grad.  Tolerance 1e-4 of
    each leaf's largest |g| (float32 sums in another order)."""
    use_float32_products(monkeypatch)
    kw = dict(seqlens=(6, 6), qkv_block_size=16, chunk_size=16, chunkwise_kernel=EXP)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 36, 32)).astype(np.float32)
    w = rng.normal(size=(2, 36, 32)).astype(np.float32)
    jm = jl.ViLBlockPair(dim=32, training=True, **kw)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = randomize(variables, rng)

    def jloss(params, xx):
        y = jm.apply({**variables, "params": params}, xx)
        return jnp.sum(y * w), y

    (_, y_ref), (g_ref, gx_ref) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    pm = tl.ViLBlockPair(32, **kw)
    pm.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    pm.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    names = [n for n, _ in pm.named_parameters()]
    g = torch.autograd.grad((y * torch.from_numpy(w)).sum(), [xt, *pm.parameters()])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=1e-4, rtol=1e-4)
    ref = {"x": np.asarray(gx_ref), **leaves_by_name(g_ref)}
    got = {"x": g[0].numpy(), **dict(zip(names, (t.numpy() for t in g[1:])))}
    assert set(ref) == set(got)
    for name, r in ref.items():
        scale = np.abs(r).max()
        np.testing.assert_allclose(got[name], r, atol=1e-4 * scale, rtol=1e-4, err_msg=name)
