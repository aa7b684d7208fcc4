"""The port's v1 chunkwise mLSTM (``ops/chunkwise.py``: forward, dC scan,
dq/dk/dv and the autograd Function, plain versions on the CPU) against the
JAX package's v1 Pallas kernels (``ops/pallas/chunkwise.py``), interpreted
on the CPU, and against ``jax.grad`` of ``mlstm_siging_chunkwise_pallas``.

Inputs are made with numpy from a seed, float32 streams, with open gates
(i ~ N(0, 1), f ~ N(2, 1)), so that many denominators do not clamp to 1.
The chunk length is part of the function (the products round their
operands to ``compute_dtype`` per chunk), so both sides get the same one.

Tolerances, relative to each output's largest |value|: 1e-4 with compute
float32 (float32 sums in another order); 2e-2 with compute bfloat16 (a
float32 sum in another order can flip the rounding of an operand by one
bfloat16 step, 2^-8 of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel import assert_rounds_where_jax_rounds
from xlstm_yolo_tpu.ops import mlstm_parallel as jax_parallel
from xlstm_yolo_tpu.ops.pallas import chunkwise as jax_v1
from xlstm_yolo_tpu_torch.ops import chunkwise as v1
from xlstm_yolo_tpu_torch.ops.mlstm_chunkwise import mlstm_siging_chunkwise
from xlstm_yolo_tpu_torch.ops.mlstm_parallel import mlstm_siging_parallel

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

EPS = 5e-5  # the model's cell eps
REL = {"float32": 1e-4, "bfloat16": 2e-2}
CASES = [  # (L, chunks, DH, compute dtype, initial states and dC_last)
    (16, 3, 16, "float32", True),
    (16, 2, 32, "bfloat16", False),
    (32, 2, 16, "bfloat16", True),
    (32, 3, 32, "float32", False),
    (64, 2, 32, "float32", True),
    (64, 2, 16, "bfloat16", False),
    (128, 2, 16, "float32", False),
    (128, 2, 32, "bfloat16", True),
    (64, 2, 64, "float32", True),     # vil-det-256's head dim
    (32, 3, 128, "bfloat16", False),  # vil-det-384's head dim
    (16, 2, 128, "float32", True),
    (16, 13, 32, "bfloat16", True),   # dC combined over the plan's 13 chunks
]
IDS = [f"L{c[0]}-{c[3]}-{'states' if c[4] else 'nostates'}" + (f"-DH{c[2]}" if c[2] > 32 else "")
       for c in CASES]


def make_inputs(seed, L, chunks, DH, states, B=2, NH=2):
    rng = np.random.default_rng(seed)
    S = L * chunks
    q, k, v, dh = (rng.normal(size=(B, NH, S, DH)).astype(np.float32) for _ in range(4))
    i = rng.normal(0, 1, (B, NH, S)).astype(np.float32)
    f = rng.normal(2, 1, (B, NH, S)).astype(np.float32)
    c0, n0, dcl = ((rng.normal(size=s).astype(np.float32) if states else None)
                   for s in ((B, NH, DH, DH), (B, NH, DH), (B, NH, DH, DH)))
    return [q, k, v, i, f, c0, n0], dh, dcl


def jx(a):
    return None if a is None else jnp.asarray(a)


def pt(a):
    return None if a is None else torch.from_numpy(np.array(a))


def assert_rel_close(got, ref, rel, names):
    for name, a, b in zip(names, got, ref):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape and np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=rel, atol=rel * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("L,chunks,DH,compute,states", CASES, ids=IDS)
def test_v1_forward_and_backward_match_jax_kernels(L, chunks, DH, compute, states):
    """``chunkwise_fw`` against ``_fw`` (h, den, C and n before each chunk,
    last states), then ``chunkwise_bw`` against ``_bw`` (dq, dk, dv, di, df,
    dC0) on JAX's saved den and C states, with dC_last when states are
    given.  With bfloat16 products the plain dq, dk and dv also lie nearer
    JAX's in mean error than the plain dq/dk/dv with float32 products does
    (on the same dC states), by more than half: the yardstick of the kernel
    rounds where ``_bw_dqkv_kernel`` does."""
    args, dh, dcl = make_inputs(L * DH, L, chunks, DH, states)
    kw = dict(chunk_size=L, eps=EPS)
    ref = jax_v1._fw(*map(jx, args), compute_dtype=getattr(jnp, compute), **kw)
    got = v1.chunkwise_fw(*map(pt, args), compute_dtype=getattr(torch, compute), **kw)
    assert_rel_close(got, ref, REL[compute], ("h", "den", "c_states", "n_states", "c_last",
                                              "n_last"))
    den, cs = np.asarray(ref[1]), np.asarray(ref[2])
    assert (den > 1).mean() > 0.2  # the gates are open: many rows do not clamp
    ref = jax_v1._bw(*map(jx, args[:5]), jx(den), jx(cs), jx(dh), dc_last=jx(dcl),
                     compute_dtype=getattr(jnp, compute), **kw)
    got = v1.chunkwise_bw(*map(pt, args[:5]), pt(den), pt(cs), pt(dh), pt(dcl),
                          compute_dtype=getattr(torch, compute), **kw)
    assert_rel_close(got, ref, REL[compute], ("dq", "dk", "dv", "di", "df", "dc0"))
    if compute == "bfloat16":
        q, k, v, i, f = map(pt, args[:5])
        dcs, _ = v1.chunkwise_bw_dc_plain(q, f, pt(dh), pt(den), pt(dcl),
                                          compute_dtype=torch.bfloat16, **kw)
        got32 = v1.chunkwise_bw_dqkv_plain(q, k, v, i, f, pt(cs), pt(den), pt(dh), dcs,
                                           compute_dtype=torch.float32, **kw)
        assert_rounds_where_jax_rounds(got[:3], got32, ref[:3], ("dq", "dk", "dv"))


def jax_value_and_grads(args, wh, wc, L, compute):
    q, k, v, i, f, c0, n0 = map(jx, args)
    states = c0 is not None

    def loss(q, k, v, i, f, c0):
        h, (c_last, _) = jax_v1.mlstm_siging_chunkwise_pallas(
            q, k, v, i, f, chunk_size=L, c_initial=c0, n_initial=n0, return_last_states=True,
            eps=EPS, compute_dtype=getattr(jnp, compute))
        return jnp.sum(h * wh) + (jnp.sum(c_last * wc) if states else 0.0), h

    argnums = (0, 1, 2, 3, 4, 5) if states else (0, 1, 2, 3, 4)
    (_, h), g = jax.value_and_grad(loss, argnums=argnums, has_aux=True)(q, k, v, i, f, c0)
    return np.asarray(h), [np.asarray(x) for x in g]


def port_value_and_grads(args, wh, wc, L, compute, fn=None):
    t = [None if a is None else pt(a).requires_grad_(j != 6) for j, a in enumerate(args)]
    if fn is None:
        h, (c_last, _) = v1.mlstm_siging_chunkwise_v1(
            *t[:5], chunk_size=L, c_initial=t[5], n_initial=t[6], return_last_states=True,
            eps=EPS, compute_dtype=getattr(torch, compute))
    else:
        h, (c_last, _) = fn(*t[:5], c_initial=t[5], n_initial=t[6])
    loss = (h * pt(wh)).sum()
    if t[5] is not None:
        loss = loss + (c_last * pt(wc)).sum()
    leaves = [x for x in t[:6] if x is not None]
    return h.detach().numpy(), [g.numpy() for g in torch.autograd.grad(loss, leaves)], c_last


@pytest.mark.parametrize("L,chunks,DH,compute,states", CASES[::2], ids=IDS[::2])
def test_v1_function_gradients_match_jax_grad(L, chunks, DH, compute, states):
    """The autograd Function against jax.grad through the custom VJP: the
    gradients of q, k, v, i, f and, with initial states, c_initial (dC0;
    n_initial's is zero on both sides), the loss taking dC_last too."""
    args, wh, wc = make_inputs(L + DH + 1, L, chunks, DH, states)
    h_ref, g_ref = jax_value_and_grads(args, wh, wc, L, compute)
    h, g, _ = port_value_and_grads(args, wh, wc, L, compute)
    rel = REL[compute]
    assert_rel_close([h], [h_ref], rel, ["h"])
    assert len(g) == len(g_ref)
    assert_rel_close(g, g_ref, rel, ("dq", "dk", "dv", "di", "df", "dc0"))


def test_v1_forget_gradient_omits_the_last_state_term_as_jax_does():
    """With an upstream dC_last, the v1 VJP takes df = revcumsum(q.dq -
    k.dk) sigmoid(-f), as the v2 one does: autograd of the same function
    (the plain chunkwise form, denominator held constant) is larger by
    sigmoid(-f_t) <dC_last, C_last> at every t.  Compute float32."""
    L = 32
    args, wh, wc = make_inputs(5, L, 3, 16, True)
    _, got, c_last = port_value_and_grads(args, wh, wc, L, "float32")

    def plain(q, k, v, i, f, c_initial, n_initial):
        return mlstm_siging_chunkwise(q, k, v, i, f, chunk_size=L, c_initial=c_initial,
                                      n_initial=n_initial, return_last_states=True, eps=EPS,
                                      stopgrad_norm=True)

    _, ref, _ = port_value_and_grads(args, wh, wc, L, "float32", fn=plain)
    term = (wc * c_last.detach().numpy()).sum((-1, -2))[..., None] / (1 + np.exp(args[4]))
    assert np.abs(term).max() > 1e-2 * np.abs(ref[4]).max()
    got[4] = got[4] + term
    assert_rel_close(got, ref, 1e-4, ("dq", "dk", "dv", "di", "df", "dc0"))


def test_parallel_oracle_matches_jax_and_the_v1_forward():
    """The quadratic oracle against JAX's, and the v1 forward (compute
    float32, two chunks) against the oracle: an independent reference."""
    args, _, _ = make_inputs(7, 32, 2, 16, False)
    q, k, v, i, f = args[:5]
    for stable in (True, False):
        ref = np.asarray(jax_parallel.mlstm_siging_parallel(*map(jx, args[:5]), eps=EPS,
                                                            stable_fgate=stable))
        got = mlstm_siging_parallel(*map(pt, args[:5]), eps=EPS, stable_fgate=stable).numpy()
        assert_rel_close([got], [ref], 1e-5, ["h"])
    h = v1.chunkwise_fw(*map(pt, args[:5]), chunk_size=32, eps=EPS,
                        compute_dtype=torch.float32)[0].numpy()
    assert_rel_close([h], [ref], 1e-4, ["h"])


def test_v1_wrappers_take_the_plain_version_only_on_the_cpu():
    """CPU tensors go to the plain versions without a launch; a tensor on
    another device is refused; S must be a multiple of the chunk."""
    args, dh, _ = make_inputs(0, 16, 2, 16, False)
    t = [pt(a) for a in args[:5]]
    before = (v1.LAUNCHES_FW, v1.LAUNCHES_BW_DC, v1.LAUNCHES_BW_DQKV)
    _, den, cs, *_ = v1.chunkwise_fw(*t, chunk_size=16)
    v1.chunkwise_bw(*t, den, cs, pt(dh), chunk_size=16)
    assert (v1.LAUNCHES_FW, v1.LAUNCHES_BW_DC, v1.LAUNCHES_BW_DQKV) == before
    meta = [a.to("meta") for a in t]
    with pytest.raises(ValueError, match="unsupported device"):
        v1.chunkwise_fw(*meta, chunk_size=16)
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        v1.chunkwise_fw(*t, chunk_size=24)
