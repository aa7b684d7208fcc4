"""The port's quadratic siging mLSTM (``ops/parallel.py``: forward, dq,
dk/dv and the autograd Function, plain versions on the CPU) against the JAX
package's Pallas kernels (``ops/pallas/parallel.py``), interpreted on the
CPU, and ``vil-det-tiny`` on the route (``chunkwise_kernel=
"parallel--pallas_limit_headdim"``) against JAX's detector on it.

Kernel inputs are made with numpy from a seed: B 2, NH 3, DH 16 (also
NH 2, DH 64 and NH 1, DH 128, the larger detectors' head dims), S in
{64, 130, 200, 448} (448 is two query tiles of the Pallas kernels, 200 a ragged
S), open gates (i ~ N(0, 1), f ~ N(3, 1): many denominators do not clamp)
or closed forget gates (f ~ U(-60, -20)).

Tolerances, relative to each output's largest |value| (atol) and rtol:
1e-5 with float32 products (float32 sums in another order; the cumsum of
the gate rows reaches about -65 at S = 448, where its rounding is ~4e-6);
2e-2 with bfloat16 products (a float32 sum in another order can flip the
rounding of an operand by one bfloat16 step, 2^-8 of it).

The tiny detector on the route rounds every cell product to bfloat16 by
default, which this random network amplifies into chaos (see
``test_torch_model.py``), so its products are float32 in both registries
for the model test, as for the v1 route's.  In eval the route has no
predict path: the port refuses it and JAX's inference wrapper fails on it.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_layers import randomize
from test_torch_model import CFG, jax_detector
from test_torch_model_exp import distances_to
from test_torch_train_step import leaves_by_name, make_batch
from xlstm_yolo_tpu.nn import layers as jl
from xlstm_yolo_tpu.nn.tasks import build_detection_model as jax_build
from xlstm_yolo_tpu.ops import backend as jax_backend
from xlstm_yolo_tpu.ops import wrappers as jax_wrappers
from xlstm_yolo_tpu.ops.pallas import parallel as jax_par
from xlstm_yolo_tpu.utils.loss import e2e_detect_loss as jax_e2e_loss
from xlstm_yolo_tpu_torch.engine import steps
from xlstm_yolo_tpu_torch.engine.model import YOLO
from xlstm_yolo_tpu_torch.nn import layers as tl
from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
from xlstm_yolo_tpu_torch.ops import backend, wrappers
from xlstm_yolo_tpu_torch.ops import parallel as par
from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict

PAR = "parallel--pallas_limit_headdim"
EPS = 5e-5  # the model's cell eps
REL = {"float32": 1e-5, "bfloat16": 2e-2}
PORT_GRAD_REL = 1e-3  # the port's float32 model gradient against its float64 one
JAX_GRAD_REL = 3e-2   # JAX's float32 model gradient against the port's float64 one


def make_inputs(seed, S, gates="open", B=2, NH=3, DH=16):
    rng = np.random.default_rng(seed)
    q, k, v, dh = (rng.normal(size=(B, NH, S, DH)).astype(np.float32) for _ in range(4))
    i = rng.normal(0, 1, (B, NH, S)).astype(np.float32)
    f = (rng.normal(3, 1, (B, NH, S)) if gates == "open"
         else rng.uniform(-60, -20, (B, NH, S))).astype(np.float32)
    return [q, k, v, i, f], dh


def assert_rel_close(got, ref, rel, names, floors=None):
    """atol = rel * max(the output's largest |value|, its floor, if any)."""
    for name, a, b in zip(names, got, ref):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape and np.isfinite(a).all(), name
        scale = max(np.abs(b).max(), (floors or {}).get(name, 0.0))
        np.testing.assert_allclose(a, b, rtol=rel, atol=rel * scale, err_msg=name)


def df_floor(q, k, dq, dk):
    """The largest revcumsum(|q.dq| + |k.dk|): df sums q.dq - k.dk in
    reverse, terms that cancel when the forget gates are closed (D is
    diagonal), so its rounding scales with them and not with df."""
    terms = np.abs((q * dq).sum(-1)) + np.abs((k * dk).sum(-1))
    return float(np.cumsum(terms[..., ::-1], axis=-1).max())


def pt(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("S,stream,compute,NH,DH", [
    pytest.param(64, "float32", "float32", 3, 16, id="64-float32-float32"),
    pytest.param(200, "float32", "bfloat16", 3, 16, id="200-float32-bfloat16"),
    pytest.param(448, "float32", "float32", 3, 16, id="448-float32-float32"),
    pytest.param(448, "bfloat16", "bfloat16", 3, 16, id="448-bfloat16-bfloat16"),
    pytest.param(200, "float32", "float32", 2, 64, id="200-float32-float32-DH64"),
    pytest.param(130, "bfloat16", "bfloat16", 1, 128, id="130-bfloat16-bfloat16-DH128"),
    pytest.param(64, "float32", "float32", 1, 128, id="64-float32-float32-DH128")])
def test_plain_versions_match_jax_kernels(S, stream, compute, NH, DH):
    """``parallel_fw_plain`` against ``_fw`` (h, den), then the two backward
    plain versions and the gate gradients against ``jax.vjp`` of
    ``mlstm_siging_parallel_pallas`` (dq, dk, dv, di, df), on JAX's den, at
    the tiny model's head dim and at vil-det-256's and vil-det-384's."""
    args, dh = make_inputs(S, S, NH=NH, DH=DH)
    jdt, tdt = getattr(jnp, stream), getattr(torch, stream)
    jargs = [jnp.asarray(a, jdt if j < 3 else jnp.float32) for j, a in enumerate(args)]
    targs = [pt(a).to(tdt if j < 3 else torch.float32) for j, a in enumerate(args)]
    tdh = pt(dh).to(tdt)
    kw = dict(eps=EPS, compute_dtype=getattr(jnp, compute))
    tkw = dict(eps=EPS, compute_dtype=getattr(torch, compute))
    rel = REL[compute]
    h_ref, n_out, _, _ = jax_par._fw(*jargs, DH ** -0.5, EPS, getattr(jnp, compute), True)
    den_ref = np.asarray(n_out).reshape(2, NH, S)
    h, den = par.parallel_fw_plain(*targs, **tkw)
    assert h.dtype == tdt and den.dtype == torch.float32
    assert_rel_close([h.float(), den], [np.asarray(h_ref, np.float32), den_ref], rel,
                     ("h", "den"))
    assert (den_ref > 1).mean() > 0.2  # open gates: many rows do not clamp

    _, vjp = jax.vjp(functools.partial(jax_par.mlstm_siging_parallel_pallas, **kw), *jargs)
    ref = vjp(jnp.asarray(dh, jdt))
    tden = pt(den_ref)
    dq = par.parallel_bw_dq_plain(*targs, tden, tdh, **tkw)
    dk, dv = par.parallel_bw_dkv_plain(*targs, tden, tdh, **tkw)
    assert dq.dtype == dk.dtype == dv.dtype == tdt
    got = par.parallel_bw(*targs, tden, tdh, **tkw)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], (dq, dk, dv)))
    assert_rel_close([x.float() for x in got], [np.asarray(r, np.float32) for r in ref], rel,
                     ("dq", "dk", "dv", "di", "df"))


@pytest.mark.parametrize("gates", ["open", "closed"])
def test_function_gradients_match_jax_grad(gates):
    """The autograd Function (the registry's entry) against jax.grad of the
    Pallas entry through its custom VJP: h and the gradients of q, k, v, i
    and f of sum(h * w), float32 products, S = 200.  df is held relative to
    its terms (``df_floor``): with closed gates it is rounding only."""
    args, w = make_inputs(7, 200, gates)
    kw = dict(eps=EPS, compute_dtype=jnp.float32)

    def loss(*a):
        h = jax_par.mlstm_siging_parallel_pallas(*a, **kw)
        return jnp.sum(h * w), h

    (_, h_ref), g_ref = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(jnp.asarray, args))
    t = [pt(a).requires_grad_() for a in args]
    fn = backend.get_mlstm_kernel(PAR)
    assert fn is par.mlstm_siging_parallel_kernel
    h = fn(*t, eps=EPS, compute_dtype=torch.float32, chunk_size=64)  # the chunk is ignored
    g = torch.autograd.grad((h * pt(w)).sum(), t)
    assert_rel_close([h.detach()], [h_ref], REL["float32"], ["h"])
    g_ref = [np.asarray(x) for x in g_ref]
    floor = df_floor(args[0], args[1], g_ref[0], g_ref[1])
    assert_rel_close(g, g_ref, REL["float32"], ("dq", "dk", "dv", "di", "df"), {"df": floor})


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """CPU tensors go to the plain versions without a launch; a tensor on
    another device is refused; the unnormalized variant raises."""
    args, dh = make_inputs(0, 64)
    t = [pt(a) for a in args]
    before = (par.LAUNCHES_FW, par.LAUNCHES_BW_DQ, par.LAUNCHES_BW_DKV)
    _, den = par.parallel_fw(*t)
    par.parallel_bw(*t, den, pt(dh))
    assert (par.LAUNCHES_FW, par.LAUNCHES_BW_DQ, par.LAUNCHES_BW_DKV) == before
    with pytest.raises(ValueError, match="unsupported device"):
        par.parallel_fw(*(a.to("meta") for a in t))
    with pytest.raises(NotImplementedError):
        par.mlstm_siging_parallel_kernel(*t, normalize=False)


def use_float32_products(mp):
    """Both registries' parallel entry with float32 products (float64 for
    the port's float64 inputs), for the duration of ``mp``."""
    jax_backend.get_mlstm_kernel(PAR)  # registers the Pallas kernels first
    mp.setitem(jax_backend._PARALLEL_REGISTRY, "pallas_limit_headdim", functools.partial(
        jax_par.mlstm_siging_parallel_pallas, compute_dtype=jnp.float32))

    def port_par(q, *args, **kw):
        cd = torch.float64 if q.dtype == torch.float64 else torch.float32
        return par.mlstm_siging_parallel_kernel(q, *args, compute_dtype=cd, **kw)
    mp.setitem(backend._REGISTRY["parallel"], "pallas_limit_headdim", port_par)


@pytest.fixture(scope="module")
def tiny_par():
    """JAX's training model on the route, perturbed tiny variables (open
    input gates), float32 products: the training-mode forward (one2many
    maps) and the loss and gradients of one E2E-loss step, one program."""
    _, _, variables, _ = jax_detector("vil-det-tiny.yaml", batch=2)
    batch = make_batch(1)
    with pytest.MonkeyPatch.context() as mp:
        use_float32_products(mp)
        jm, _ = jax_build(CFG / "vil-det-tiny.yaml", training=True, chunkwise_kernel=PAR)
        stats = variables["batch_stats"]

        def loss(params, b):
            img = b["img"].astype(jnp.float32) / 255.0
            maps, _ = jm.apply({"params": params, "batch_stats": stats}, img,
                               mutable=["batch_stats"], rngs={"droppath": jax.random.PRNGKey(3)})
            strides = [img.shape[1] / f.shape[1] for f in maps["one2many"]]
            return jax_e2e_loss(maps, b["cls"], b["bboxes"], b["mask"], strides, nc=80)[0], maps

        (value, maps), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(variables=variables, batch=batch, loss=float(value), grads=leaves_by_name(grads),
                maps=[np.asarray(m) for m in maps["one2many"]])


def test_tiny_parallel_route_forward_and_gradients_match_jax(tiny_par, monkeypatch):
    """One E2E-loss step of the training model on the route, float32
    products on both sides (float64 in the port's float64 step): every cell
    is one call of the Function at S padded to whole chunks (14 calls per
    forward); the training-mode forward's maps (atol 1e-4 of their largest
    |value|, rtol 1e-4) and the loss (rtol 1e-4) against JAX's.

    The gradients, whose JAX side goes through the Pallas custom VJP (the
    denominator held constant, as the port's kernels hold it), are held as
    on the exp route (``test_torch_model_exp.py``): the port's float64
    gradient is the arbiter, per leaf (``distances_to``).  The port's
    float32 gradient must be within PORT_GRAD_REL of it (3.4e-5 measured
    on the CPU); JAX's float32 gradient of this network is more sensitive
    (7.7e-3 from it, measured), so it is held within JAX_GRAD_REL: a wiring
    fault moves leaves by O(1), and the ViLBlockPair test below holds the
    route's gradient to JAX's at 1e-4.  Both largest distances are
    printed."""
    use_float32_products(monkeypatch)
    calls = []
    fw = par.parallel_fw

    def recording_fw(*args, **kw):
        out = fw(*args, **kw)
        calls.append((args[0].shape[2], out[1]))
        return out
    monkeypatch.setattr(par, "parallel_fw", recording_fw)
    model, _ = build_detection_model("vil-det-tiny.yaml", device="cpu", training=True,
                                     chunkwise_kernel=PAR)
    model.load_state_dict(jax_variables_to_state_dict(tiny_par["variables"]), strict=True)
    batch = {k: torch.from_numpy(v) for k, v in tiny_par["batch"].items()}
    img = batch["img"].float() / 255.0
    out = model(img)
    for got, ref in zip(out["one2many"], tiny_par["maps"]):
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    loss, _ = steps.detect_loss(model, batch)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    lengths = sorted({s for s, _ in calls})
    assert len(calls) == 2 * 14 and lengths == [32, 128, 448]  # 25, 100, 400 padded
    assert 0.1 < float(torch.cat([d.flatten() for _, d in calls]).gt(1).float().mean()) < 0.9
    np.testing.assert_allclose(loss.item(), tiny_par["loss"], rtol=1e-4)
    model64 = copy.deepcopy(model).double()
    loss64, _ = steps.detect_loss(model64, dict(batch, bboxes=batch["bboxes"].double()))
    g64 = dict(zip(names, (g.numpy() for g in torch.autograd.grad(
        loss64, list(model64.parameters())))))
    ref = tiny_par["grads"]
    assert set(ref) == set(grads)
    port_errs = distances_to(g64, {name: g.numpy() for name, g in grads.items()})
    jax_errs = distances_to(g64, ref)
    for name in ref:
        assert port_errs[name] <= PORT_GRAD_REL, (name, port_errs[name])
        assert jax_errs[name] <= JAX_GRAD_REL, (name, jax_errs[name], port_errs[name])
    print(f"largest distance from the port's float64 gradient: port float32 "
          f"{max(port_errs.values()):.3g}, JAX float32 {max(jax_errs.values()):.3g}")


def test_vil_block_pair_gradients_match_jax_on_the_parallel_route(monkeypatch):
    """A ViLBlockPair in training on the route (S = 36 zero-padded to 48 at
    chunk 16, 4 heads of 16, every parameter ~ 0.2 N(0, 1)), float32
    products in both registries: the output and the gradients of sum(y * w)
    with respect to every parameter and the input, against jax.grad.
    Tolerance 1e-4 of each leaf's largest |g| (float32 sums in another
    order)."""
    use_float32_products(monkeypatch)
    kw = dict(seqlens=(6, 6), qkv_block_size=16, chunk_size=16, chunkwise_kernel=PAR)
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 36, 32)).astype(np.float32)
    w = rng.normal(size=(2, 36, 32)).astype(np.float32)
    jm = jl.ViLBlockPair(dim=32, training=True, **kw)
    variables = randomize(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                           jnp.asarray(x))), rng)

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
        np.testing.assert_allclose(got[name], r, atol=1e-4 * np.abs(r).max(), rtol=1e-4,
                                   err_msg=name)


def test_predict_on_the_route_is_refused_and_fails_in_jax():
    """The route has no predict path.  The port's inference wrapper refuses
    a kernel that returns no (h, state) pair, naming it, and so does
    ``YOLO(..., chunkwise_kernel=PAR).predict``; JAX's wrapper unpacks h
    along the batch axis and fails at B = 3 (at B = 2 it would read h[1]
    as the state: ROADMAP Queue 3)."""
    args, _ = make_inputs(3, 64, B=3)
    names = (PAR, "sequence--native", "step--native")
    with pytest.raises(ValueError, match="too many values to unpack"):
        jax_wrappers.wrap_chunkwise_arbitrary_sequence_length(
            *(jax_backend.get_mlstm_kernel(n) for n in names), *map(jnp.asarray, args),
            chunk_size=64, eps=EPS)
    with pytest.raises(ValueError, match="mlstm_siging_parallel_kernel returned no"):
        wrappers.wrap_chunkwise_arbitrary_sequence_length(
            *(backend.get_mlstm_kernel(n) for n in names), *map(pt, args), chunk_size=64,
            eps=EPS)
    yolo = YOLO("vil-det-tiny.yaml", device="cpu", compute_dtype=torch.float32,
                chunkwise_kernel=PAR)
    assert all(m.chunkwise_kernel == PAR for m in yolo.model.modules()
               if isinstance(m, MatrixLSTMCell))
    image = np.random.default_rng(0).integers(0, 256, (120, 160, 3), dtype=np.uint8)
    with pytest.raises(ValueError, match="mlstm_siging_parallel_kernel returned no"):
        yolo.predict([image])
