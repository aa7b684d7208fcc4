"""The port's one-token step (``ops/step.py``, the registry's
``step--pallas``; its plain version on the CPU) against the JAX package's
Pallas step kernel (``ops/pallas/step.py``), interpreted on the CPU; and the
stateful ``MatrixLSTMCell`` (``forward(q, k, v, state=...)``) against JAX's
cell, whose variables it takes through ``utils/convert``.

Inputs are made with numpy from a seed.  The cells: dim 64, 4 heads of 16,
every parameter ~ 0.2 N(0, 1) (so the gates range widely), in eval, with a
random initial state (C, n).  On the v1 name the cell's products are
float32 in both registries (its bfloat16 products alone move h by a few
percent), as in ``test_torch_model.py``.

Tolerances: the step, float32 atol = rtol = 1e-5 of each output's largest
|value| (the same float32 arithmetic, sums in another order); bfloat16
streams 2e-2 for h (rounded once to bfloat16 on both sides), 1e-5 for the
float32 states.  The cells: h after the per-head LayerNorm atol = rtol =
2e-4 (as ``test_torch_layers.py``), the states 1e-4 of their largest
|value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_layers import randomize
from test_torch_model import use_float32_products
from xlstm_yolo_tpu.nn import layers as jl
from xlstm_yolo_tpu.ops import backend as jax_backend
from xlstm_yolo_tpu.ops.pallas.step import mlstm_siging_step_pallas
from xlstm_yolo_tpu_torch.nn import layers as tl
from xlstm_yolo_tpu_torch.ops import backend
from xlstm_yolo_tpu_torch.ops import step as step_mod
from xlstm_yolo_tpu_torch.ops.mlstm_recurrent import mlstm_siging_step
from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

EPS = 5e-5  # the model's cell eps
V1, V2 = backend.V1_KERNEL, backend.V2_KERNEL
DIM, NH = 64, 4


def step_inputs(seed, gates, B=2, DH=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, NH, DH)).astype(np.float32) for _ in range(3))
    i = rng.normal(0, 2, (B, NH)).astype(np.float32)
    f = (rng.normal(2, 1, (B, NH)) if gates == "open"
         else rng.uniform(-60, -20, (B, NH))).astype(np.float32)
    c = rng.normal(size=(B, NH, DH, DH)).astype(np.float32)
    n = rng.normal(size=(B, NH, DH)).astype(np.float32)
    return q, k, v, i, f, c, n


def assert_rel_close(got, ref, rel, names):
    for name, a, b in zip(names, got, ref):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape and np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=rel, atol=rel * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gates,DH", [
    pytest.param("open", 16, id="open"), pytest.param("closed", 16, id="closed"),
    pytest.param("open", 64, id="open-DH64"), pytest.param("closed", 128, id="closed-DH128"),
    pytest.param("open", 128, id="open-DH128")])
def test_step_matches_jax_pallas_step(gates, DH, dtype):
    """``mlstm_siging_step_kernel`` on CPU tensors (the plain step, no
    launch) against ``mlstm_siging_step_pallas``: h and (C', n'), at DH 16
    and at the larger detectors' 64 and 128."""
    args = step_inputs(1 if gates == "open" else 2, gates, DH=DH)
    jargs = [jnp.asarray(a, getattr(jnp, dtype) if j < 3 else jnp.float32)
             for j, a in enumerate(args)]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype) if j < 3 else torch.float32)
             for j, a in enumerate(args)]
    h_ref, (c_ref, n_ref) = mlstm_siging_step_pallas(*jargs, eps=EPS)
    before = step_mod.LAUNCHES
    fn = backend.get_mlstm_kernel(backend.STEP_KERNEL)
    assert fn is step_mod.mlstm_siging_step_kernel
    h, (c, n) = fn(*targs, eps=EPS)
    assert step_mod.LAUNCHES == before and h.dtype == targs[0].dtype
    assert_rel_close([h.float()], [np.asarray(h_ref, np.float32)],
                     1e-5 if dtype == "float32" else 2e-2, ["h"])
    assert_rel_close([c, n], [c_ref, n_ref], 1e-5, ["C", "n"])
    hp, _ = mlstm_siging_step(*targs, eps=EPS)
    assert torch.equal(h, hp)  # the plain version on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*(t.to("meta") for t in targs))


def float32_products(mp):
    """The v1 entry with float32 products in both registries, after the JAX
    package has registered its Pallas kernels (which would overwrite it)."""
    jax_backend.get_mlstm_kernel("step--pallas")
    use_float32_products(mp)


def cells(name, seed, S):
    """(JAX cell, its variables, port cell, inputs (B 2, S), rng) with the
    same random weights (initialised at 8 tokens: they do not depend on S)."""
    rng = np.random.default_rng(seed)
    x = [rng.normal(size=(2, S, DIM)).astype(np.float32) for _ in range(3)]
    jm = jl.MatrixLSTMCell(dim=DIM, num_heads=NH, mode="inference", chunkwise_kernel=name,
                           step_kernel="step--pallas")
    variables = randomize(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), *(jnp.asarray(a[:, :8]) for a in x))), rng)
    pm = tl.MatrixLSTMCell(DIM, NH, chunkwise_kernel=name, step_kernel="step--pallas")
    pm.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return jm, variables, pm.eval(), x, rng


@pytest.mark.parametrize("name,S", [(V1, 1), (V1, 37), (V2, 1), (V2, 37), (V2, 400)])
def test_stateful_cell_matches_jax(name, S, monkeypatch):
    """The stateful call from a random state: S = 1 is one step of
    ``step--pallas`` on both routes.  On the v1 name S = 37 is a 32-token
    segment of the v1 kernel and a 5-token recurrent tail, in both
    packages.  On the v2 name S = 37 and S = 400 are one call of the port's
    v2 inference forward from the state (on the CPU its plain version),
    while JAX, below its TPU cut-over of 1024 tokens, runs
    ``chunkwise--native_autograd`` segments and the recurrent tail: in
    float32 the same function.  h and the last (C, n)."""
    float32_products(monkeypatch)
    jm, variables, pm, x, rng = cells(name, S + len(name), S)
    c0 = rng.normal(size=(2, NH, 16, 16)).astype(np.float32)
    n0 = rng.normal(size=(2, NH, 16)).astype(np.float32)
    h_ref, (c_ref, n_ref) = jm.apply(variables, *map(jnp.asarray, x),
                                     state=(jnp.asarray(c0), jnp.asarray(n0)))
    with torch.no_grad():
        h, (c, n) = pm(*map(torch.from_numpy, x), state=(torch.from_numpy(c0),
                                                         torch.from_numpy(n0)))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=2e-4, rtol=2e-4)
    assert_rel_close([c, n], [c_ref, n_ref], 1e-4, ["C", "n"])


@pytest.mark.parametrize("name", [V1, V2])
def test_decode_equals_the_stateful_forward(name, monkeypatch):
    """16 tokens decoded one at a time (each a step of ``step--pallas``),
    threading the state, equal one stateful call over the 16 tokens from
    the same state: h of every token and the last (C, n)."""
    float32_products(monkeypatch)
    _, _, pm, x, rng = cells(name, 5, 16)
    state = (torch.from_numpy(rng.normal(size=(2, NH, 16, 16)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(2, NH, 16)).astype(np.float32)))
    q, k, v = map(torch.from_numpy, x)
    with torch.no_grad():
        h_all, (c_all, n_all) = pm(q, k, v, state=state)
        hs, st = [], state
        for t in range(16):
            h, st = pm(q[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], state=st)
            hs.append(h)
    np.testing.assert_allclose(torch.cat(hs, 1).numpy(), h_all.numpy(), atol=2e-4, rtol=2e-4)
    assert_rel_close(st, [c_all, n_all], 1e-4, ["C", "n"])


def test_v2_name_runs_its_kernel_from_the_state_at_long_sequences():
    """At S = 1024, where JAX's cell too runs its v2 kernel, the v2 name
    runs the v2 inference forward from the state (on the CPU its plain
    version); the same weights on ``chunkwise--native_autograd`` give the
    same h and state.  Training refuses a state."""
    _, _, pm, x, rng = cells(V2, 9, 1024)
    native = tl.MatrixLSTMCell(DIM, NH, chunkwise_kernel="chunkwise--native_autograd")
    native.load_state_dict(pm.state_dict(), strict=True)
    native.eval()
    state = (torch.from_numpy(rng.normal(size=(2, NH, 16, 16)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(2, NH, 16)).astype(np.float32)))
    seen = []
    kernel = pm.kernel
    pm.kernel = lambda *a, **kw: seen.append(a[0].shape) or kernel(*a, **kw)
    with torch.no_grad():
        h, (c, n) = pm(*map(torch.from_numpy, x), state=state)
        h_ref, (c_ref, n_ref) = native(*map(torch.from_numpy, x), state=state)
    assert seen == [(2, 1024, DIM)]
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), atol=2e-4, rtol=2e-4)
    assert_rel_close([c, n], [c_ref, n_ref], 1e-4, ["C", "n"])
    with pytest.raises(ValueError, match="inference mode only"):
        pm.train()(*map(torch.from_numpy, x), state=state)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_stateful_v2_cell_builds_no_registry_backend_above_one_token(fuse, monkeypatch):
    """With a state, the v2 name at S = 37 and 400 (below JAX's TPU
    cut-over) makes one call of the v2 inference forward (the entry with
    the LayerNorm fused in under ``fuse_outnorm``) and never builds the
    registry backend; S = 1 builds it (the decode path: one step) and calls
    no v2 entry."""
    _, _, pm, x, rng = cells(V2, 3, 400)
    pm.fuse_outnorm = fuse
    built, seen = [], []
    make = tl.make_backend
    monkeypatch.setattr(tl, "make_backend", lambda cfg: built.append(cfg) or make(cfg))
    fused_fw = tl.mlstm_siging_chunkwise_fw_ln
    monkeypatch.setattr(tl, "mlstm_siging_chunkwise_fw_ln",
                        lambda *a, **kw: seen.append(("ln", a[0].shape[1])) or fused_fw(*a, **kw))
    kernel = pm.kernel
    pm.kernel = lambda *a, **kw: seen.append(("fw", a[0].shape[1])) or kernel(*a, **kw)
    state = (torch.from_numpy(rng.normal(size=(2, NH, 16, 16)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(2, NH, 16)).astype(np.float32)))
    q, k, v = map(torch.from_numpy, x)
    entry = "ln" if fuse else "fw"
    with torch.no_grad():
        for S in (37, 400):
            h, (c, n) = pm(q[:, :S], k[:, :S], v[:, :S], state=state)
            assert h.shape == (2, S, DIM) and c.shape == state[0].shape
            assert seen == [(entry, S)] and built == []
            seen.clear()
        pm(q[:, :1], k[:, :1], v[:, :1], state=state)
    assert seen == [] and len(built) == 1 and built[0].return_last_states
