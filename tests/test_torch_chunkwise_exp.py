"""The port's exponential-input-gate mLSTM against the JAX package's, on the
CPU: the stabilized plain functions (``ops/mlstm_recurrent.py``,
``ops/mlstm_chunkwise.py``, ``ops/mlstm_parallel.py``), and the exp route
(``ops/chunkwise_exp.py``: forward, dC scan, dq/dk/dv and the autograd
Function, plain versions on the CPU) against the JAX Pallas kernels of
``ops/pallas/chunkwise_exp.py``, interpreted on the CPU, and against
``jax.grad`` of ``mlstm_chunkwise_exp_pallas``.

Inputs are made with numpy from a seed, float32 streams, in three gate
regimes: open (i ~ N(0, 1), f ~ N(2, 1)), large input gates (i ~ U(5, 15),
up to the soft cap, so that m moves far from 0) and closed forget gates
(f ~ U(-8, -3)).  The chunk length is part of the exp route's function (its
products round their operands to ``compute_dtype`` per chunk), so both
sides get the same one.

Tolerances, relative to each output's largest |value| (the exp-gate
gradients reach ~1e4): 1e-4 with float32 products (float32 sums in another
order); 2e-2 with bfloat16 products (a float32 sum in another order can
flip the rounding of an operand by one bfloat16 step, 2^-8 of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.ops import mlstm_chunkwise as jax_chunkwise
from xlstm_yolo_tpu.ops import mlstm_parallel as jax_parallel
from xlstm_yolo_tpu.ops import mlstm_recurrent as jax_recurrent
from xlstm_yolo_tpu.ops.pallas import chunkwise_exp as jax_exp
from xlstm_yolo_tpu_torch.ops import chunkwise_exp as exp
from xlstm_yolo_tpu_torch.ops.mlstm_chunkwise import mlstm_chunkwise_stabilized
from xlstm_yolo_tpu_torch.ops.mlstm_parallel import mlstm_parallel_stabilized
from xlstm_yolo_tpu_torch.ops.mlstm_recurrent import (
    mlstm_recurrent_sequence_stabilized,
    mlstm_step_stabilized,
)

EPS = 5e-5  # the model's cell eps
REL = {"float32": 1e-4, "bfloat16": 2e-2}
GATES = ("open", "large_i", "closed")
CASES = [  # (L, chunks, DH, compute dtype, gates, initial (C, n, m) and dC_last)
    (16, 3, 16, "float32", "large_i", True),
    (16, 2, 32, "bfloat16", "open", False),
    (32, 2, 16, "bfloat16", "closed", True),
    (32, 3, 32, "float32", "open", False),
    (64, 2, 32, "float32", "closed", True),
    (64, 2, 16, "bfloat16", "large_i", False),
    (128, 2, 16, "float32", "open", False),
    (128, 2, 32, "bfloat16", "large_i", True),
    (64, 2, 64, "float32", "open", True),       # vil-det-256's head dim
    (32, 3, 128, "bfloat16", "large_i", False),  # vil-det-384's head dim
    (16, 2, 128, "float32", "closed", True),
]
IDS = [f"L{c[0]}-{c[3]}-{c[4]}-{'states' if c[5] else 'nostates'}"
       + (f"-DH{c[2]}" if c[2] > 32 else "") for c in CASES]


def make_inputs(seed, S, DH, gates, states, B=2, NH=2):
    """[q, k, v, i, f, c0, n0, m0], dh, dC_last as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    q, k, v, dh = (rng.normal(size=(B, NH, S, DH)).astype(np.float32) for _ in range(4))
    i = (rng.uniform(5, 15, (B, NH, S)) if gates == "large_i"
         else rng.normal(0, 1, (B, NH, S))).astype(np.float32)
    f = (rng.uniform(-8, -3, (B, NH, S)) if gates == "closed"
         else rng.normal(2, 1, (B, NH, S))).astype(np.float32)
    c0, n0, dcl = ((rng.normal(size=s).astype(np.float32) if states else None)
                   for s in ((B, NH, DH, DH), (B, NH, DH), (B, NH, DH, DH)))
    m0 = rng.normal(0, 3, (B, NH)).astype(np.float32) if states else None
    return [q, k, v, i, f, c0, n0, m0], dh, dcl


def jx(a):
    return None if a is None else jnp.asarray(a)


def pt(a):
    return None if a is None else torch.from_numpy(np.array(a))


def assert_rel_close(got, ref, rel, names):
    for name, a, b in zip(names, got, ref):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=rel, atol=rel * np.abs(b).max(), err_msg=name)


# ---------------------------------------------------------------------------
# the stabilized plain functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gates", GATES)
def test_stabilized_step_and_sequence_match_jax(gates):
    """One step and the recurrent sequence from (C, n, m), h and the last
    states."""
    args, _, _ = make_inputs(1, 24, 16, gates, True)
    q, k, v, i, f, c0, n0, m0 = args
    ref = jax_recurrent.mlstm_step_stabilized(*map(jx, (q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                                        i[..., 0], f[..., 0], c0, n0, m0)))
    got = mlstm_step_stabilized(*map(pt, (q[:, :, 0], k[:, :, 0], v[:, :, 0], i[..., 0],
                                          f[..., 0], c0, n0, m0)))
    assert_rel_close((got[0], *got[1]), (ref[0], *ref[1]), 1e-5, ("h", "C", "n", "m"))
    kw = dict(eps=EPS, return_last_states=True)
    ref = jax_recurrent.mlstm_recurrent_sequence_stabilized(*map(jx, args), **kw)
    got = mlstm_recurrent_sequence_stabilized(*map(pt, args), **kw)
    assert_rel_close((got[0], *got[1]), (ref[0], *ref[1]), 1e-4, ("h", "C", "n", "m"))


@pytest.mark.parametrize("gates,states,dtype", [
    ("open", False, "float32"), ("large_i", True, "float32"), ("closed", True, "float32"),
    ("large_i", False, "bfloat16")])
def test_chunkwise_stabilized_matches_jax_and_the_recurrence(gates, states, dtype):
    """``mlstm_chunkwise_stabilized`` (h and (C, n, m)) against JAX's, on
    float32 streams and on bfloat16 ones (its products round to the
    stream's type); in float32 also against the recurrent sequence, an
    independent form of the same function."""
    args, _, _ = make_inputs(2, 64, 16, gates, states)
    kw = dict(chunk_size=16, eps=EPS, return_last_states=True)
    streams = [a.astype(jnp.bfloat16) if dtype == "bfloat16" else a for a in map(jx, args[:3])]
    ref = jax_chunkwise.mlstm_chunkwise_stabilized(
        *streams, *map(jx, args[3:5]), c_initial=jx(args[5]), n_initial=jx(args[6]),
        m_initial=jx(args[7]), **kw)
    t = [pt(np.asarray(a, np.float32)).to(getattr(torch, dtype)) for a in streams]
    got = mlstm_chunkwise_stabilized(*t, *map(pt, args[3:5]), c_initial=pt(args[5]),
                                     n_initial=pt(args[6]), m_initial=pt(args[7]), **kw)
    rel = REL[dtype]
    assert_rel_close((got[0].float(), *got[1]), (np.asarray(ref[0], np.float32), *ref[1]), rel,
                     ("h", "C", "n", "m"))
    if dtype == "float32":
        rec = mlstm_recurrent_sequence_stabilized(*map(pt, args), eps=EPS,
                                                  return_last_states=True)
        # C and n are relative to m: compare C e^m, n e^m
        scale = lambda st: (st[0] * st[2].exp()[..., None, None], st[1] * st[2].exp()[..., None])  # noqa: E731
        assert_rel_close((got[0], *scale(got[1])), (rec[0], *scale(rec[1])), 1e-4,
                         ("h", "C e^m", "n e^m"))


@pytest.mark.parametrize("stopgrad_norm", [True, False])
@pytest.mark.parametrize("gates", ["large_i", "closed"])
def test_chunkwise_stabilized_gradients_match_jax_grad(stopgrad_norm, gates):
    """Autograd through ``mlstm_chunkwise_stabilized`` against jax.grad, the
    stabilizers and the denominator detached or differentiated; gradients
    of q, k, v, i, f, c_initial, n_initial (and m_initial), the loss taking
    the last (C, n) too."""
    args, wh, wc = make_inputs(3, 48, 16, gates, True)
    kw = dict(chunk_size=16, eps=EPS, return_last_states=True, stopgrad_norm=stopgrad_norm)

    def jloss(*a):
        h, (c, n, _) = jax_chunkwise.mlstm_chunkwise_stabilized(
            *a[:5], c_initial=a[5], n_initial=a[6], m_initial=a[7], **kw)
        return jnp.sum(h * wh) + jnp.sum(c * wc) + jnp.sum(n)

    ref = jax.grad(jloss, argnums=tuple(range(8)))(*map(jx, args))
    t = [pt(a).requires_grad_() for a in args]
    h, (c, n, _) = mlstm_chunkwise_stabilized(*t[:5], c_initial=t[5], n_initial=t[6],
                                              m_initial=t[7], **kw)
    loss = (h * pt(wh)).sum() + (c * pt(wc)).sum() + n.sum()
    got = torch.autograd.grad(loss, t)
    assert_rel_close(got, ref, 1e-4, ("dq", "dk", "dv", "di", "df", "dc0", "dn0", "dm0"))


@pytest.mark.parametrize("rowwise", [True, False])
def test_parallel_stabilized_matches_jax_and_the_chunkwise_form(rowwise):
    """The quadratic oracle against JAX's; row-wise, also against the
    chunkwise form (an independent reference)."""
    args, _, _ = make_inputs(4, 64, 16, "large_i", False)
    ref = np.asarray(jax_parallel.mlstm_parallel_stabilized(*map(jx, args[:5]), eps=EPS,
                                                            stabilize_rowwise=rowwise))
    got = mlstm_parallel_stabilized(*map(pt, args[:5]), eps=EPS, stabilize_rowwise=rowwise)
    assert_rel_close([got], [ref], 1e-4, ["h"])
    if rowwise:
        h = mlstm_chunkwise_stabilized(*map(pt, args[:5]), chunk_size=32, eps=EPS)
        assert_rel_close([h], [ref], 1e-4, ["h"])


# ---------------------------------------------------------------------------
# the exp route's kernels (plain versions) and Function
# ---------------------------------------------------------------------------


def jax_fw(args, L, compute, save_states):
    q, k, v, i, f, c0, n0, m0 = map(jx, args)
    if c0 is not None and m0 is None:
        m0 = jnp.zeros(q.shape[:2], jnp.float32)
    return jax_exp._fw(q, k, v, i, f, c0, n0, m0, chunk_size=L, eps=EPS,
                       compute_dtype=getattr(jnp, compute), save_states=save_states)


@pytest.mark.parametrize("L,chunks,DH,compute,gates,states", CASES, ids=IDS)
def test_exp_forward_and_backward_match_jax_kernels(L, chunks, DH, compute, gates, states):
    """``chunkwise_exp_fw`` against ``_fw`` in both variants (training: h,
    den and m_comb per row, C and m before each chunk, the last (C, n, m);
    predict: h and the last states), then ``chunkwise_exp_bw`` against
    ``_bw`` (dq, dk, dv, di, df, dC0) on JAX's saved rows, with dC_last when
    states are given."""
    args, dh, dcl = make_inputs(L * DH, L * chunks, DH, gates, states)
    B, NH, S, _ = args[0].shape
    cd = getattr(torch, compute)
    rel = REL[compute]
    ref = jax_fw(args, L, compute, True)
    got = exp.chunkwise_exp_fw(*map(pt, args), chunk_size=L, eps=EPS, compute_dtype=cd)
    flat = lambda x, *s: np.asarray(x).reshape(*s)  # noqa: E731
    ref_rows = [ref[0], flat(ref[1], B, NH, S), flat(ref[2], B, NH, S),
                flat(ref[3], B, NH, S // L, DH, DH), flat(ref[4], B, NH, S // L), *ref[5]]
    names = ("h", "den", "m_comb", "c_states", "m_states", "c_last", "n_last", "m_last")
    assert_rel_close([*got[:5], *got[5]], ref_rows, rel, names)
    if gates == "large_i":
        assert np.asarray(ref[5][2]).min() > 4  # the stabilizer moved far from 0
    ref_p = jax_fw(args, L, compute, False)
    got_p = exp.chunkwise_exp_fw(*map(pt, args), chunk_size=L, eps=EPS, compute_dtype=cd,
                                 save_states=False)
    assert got_p[1:5] == (None,) * 4
    assert_rel_close([got_p[0], *got_p[5]], [ref_p[0], *ref_p[5]], rel,
                     ("h", "c_last", "n_last", "m_last"))
    den, mc, cs, ms, m_last = ref_rows[1:5] + [ref_rows[7]]
    ref_b = jax_exp._bw(*map(jx, args[:5]), ref[1], ref[2], ref[3], ref[4], ref[5][2], jx(dh),
                        dc_last=jx(dcl), chunk_size=L, eps=EPS,
                        compute_dtype=getattr(jnp, compute))
    got_b = exp.chunkwise_exp_bw(*map(pt, args[:5]), *map(pt, (den, mc, cs, ms, m_last, dh)),
                                 pt(dcl), chunk_size=L, eps=EPS, compute_dtype=cd)
    assert_rel_close(got_b, ref_b, rel, ("dq", "dk", "dv", "di", "df", "dc0"))


def jax_value_and_grads(args, wh, wc, L, compute):
    q, k, v, i, f, c0, n0, m0 = map(jx, args)
    states = c0 is not None

    def loss(q, k, v, i, f, c0):
        h, (c_last, _, _) = jax_exp.mlstm_chunkwise_exp_pallas(
            q, k, v, i, f, chunk_size=L, c_initial=c0, n_initial=n0, m_initial=m0,
            return_last_states=True, eps=EPS, compute_dtype=getattr(jnp, compute))
        return jnp.sum(h * wh) + (jnp.sum(c_last * wc) if states else 0.0), h

    argnums = (0, 1, 2, 3, 4, 5) if states else (0, 1, 2, 3, 4)
    (_, h), g = jax.value_and_grad(loss, argnums=argnums, has_aux=True)(q, k, v, i, f, c0)
    return np.asarray(h), [np.asarray(x) for x in g]


def port_value_and_grads(args, wh, wc, L, compute):
    t = [None if a is None else pt(a).requires_grad_(j < 6) for j, a in enumerate(args)]
    h, (c_last, _, _) = exp.mlstm_chunkwise_exp(
        *t[:5], chunk_size=L, c_initial=t[5], n_initial=t[6], m_initial=t[7],
        return_last_states=True, eps=EPS, compute_dtype=getattr(torch, compute))
    loss = (h * pt(wh)).sum()
    if t[5] is not None:
        loss = loss + (c_last * pt(wc)).sum()
    leaves = [x for x in t[:6] if x is not None]
    return h.detach().numpy(), [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("L,chunks,DH,compute,gates,states", CASES[::2], ids=IDS[::2])
def test_exp_function_gradients_match_jax_grad(L, chunks, DH, compute, gates, states):
    """The autograd Function against jax.grad through the custom VJP: the
    gradients of q, k, v, i, f and, with initial (C, n, m), c_initial (dC0,
    in the scaling of m_initial), the loss taking dC_last too."""
    args, wh, wc = make_inputs(L + DH + 1, L * chunks, DH, gates, states)
    h_ref, g_ref = jax_value_and_grads(args, wh, wc, L, compute)
    h, g = port_value_and_grads(args, wh, wc, L, compute)
    rel = REL[compute]
    assert_rel_close([h], [h_ref], rel, ["h"])
    assert len(g) == len(g_ref)
    assert_rel_close(g, g_ref, rel, ("dq", "dk", "dv", "di", "df", "dc0"))


@pytest.mark.parametrize("gates", GATES)
def test_exp_split_sequence_threads_c_n_m(gates):
    """S split in two, (C, n, m) threaded from the first half into the
    second, gives the unsplit h (float32 products); and the exp route
    without initial states equals the stabilized chunkwise form."""
    args, _, _ = make_inputs(6, 64, 16, gates, False)
    t = list(map(pt, args[:5]))
    kw = dict(chunk_size=16, eps=EPS, compute_dtype=torch.float32)
    h = exp.mlstm_chunkwise_exp(*t, **kw)
    h1, (c, n, m) = exp.mlstm_chunkwise_exp(*(x[:, :, :32] for x in t), return_last_states=True,
                                            **kw)
    h2 = exp.mlstm_chunkwise_exp(*(x[:, :, 32:] for x in t), c_initial=c, n_initial=n,
                                 m_initial=m, **kw)
    assert_rel_close([torch.cat([h1, h2], 2)], [h], 1e-4, ["h"])
    ref = mlstm_chunkwise_stabilized(*t, chunk_size=16, eps=EPS)
    assert_rel_close([h], [ref], 1e-4, ["h"])


def test_exp_predict_forward_saves_nothing_and_counts_no_launch():
    """Without gradients the entry runs the forward without the saved rows
    (the predict variant); CPU tensors reach the plain versions with no
    launch; a tensor on another device is refused; m_initial needs C and n."""
    args, dh, _ = make_inputs(0, 32, 16, "open", False)
    t = [pt(a) for a in args[:5]]
    before = (exp.LAUNCHES_FW, exp.LAUNCHES_BW_DC, exp.LAUNCHES_BW_DQKV)
    calls = []
    fw = exp.chunkwise_exp_fw

    def spy(*a, **kw):
        calls.append(kw["save_states"])
        return fw(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(exp, "chunkwise_exp_fw", spy)
        with torch.no_grad():
            exp.mlstm_chunkwise_exp(*t, chunk_size=16)
        grads = [x.clone().requires_grad_() for x in t]
        h = exp.mlstm_chunkwise_exp(*grads, chunk_size=16)
        torch.autograd.grad((h * pt(dh)).sum(), grads)
    assert calls == [False, True]
    assert (exp.LAUNCHES_FW, exp.LAUNCHES_BW_DC, exp.LAUNCHES_BW_DQKV) == before
    with pytest.raises(ValueError, match="unsupported device"):
        exp.chunkwise_exp_fw(*[a.to("meta") for a in t], chunk_size=16)
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        exp.chunkwise_exp_fw(*t, chunk_size=24)
    with pytest.raises(ValueError, match="m_initial needs"):
        exp.chunkwise_exp_fw(*t, m_initial=torch.zeros(2, 2), chunk_size=16)


def test_exp_registry_entry_rounds_products_to_bfloat16_by_default():
    """The registry's entry defaults to bfloat16 products, as the JAX
    kernel's entry does (``chunkwise_exp.py:574``)."""
    args, _, _ = make_inputs(8, 32, 16, "large_i", False)
    ref = np.asarray(jax_exp.mlstm_chunkwise_exp_pallas(*map(jx, args[:5]), chunk_size=16,
                                                        eps=EPS))
    got = exp.mlstm_chunkwise_exp(*map(pt, args[:5]), chunk_size=16, eps=EPS)
    f32 = exp.mlstm_chunkwise_exp(*map(pt, args[:5]), chunk_size=16, eps=EPS,
                                  compute_dtype=torch.float32)
    assert_rel_close([got], [ref], REL["bfloat16"], ["h"])
    assert np.abs(got.numpy() - f32.numpy()).max() > 1e-5 * np.abs(ref).max()
