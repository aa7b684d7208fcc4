"""The port's differentiable mLSTM cell (train forward + backward, plain
versions on the CPU) against the JAX package's Pallas v2 cell under
``jax.grad``, with its Pallas forward and backward interpreted on the CPU.

Both hold the max(|.|, 1) denominator constant in the gradient.  The JAX
package's own CPU training path (``chunkwise--native_autograd``)
differentiates through it instead; the last test shows that the two
differ once the gates are open.

Inputs are made with numpy from a seed; float32.  Tolerance: forward
atol = rtol = 1e-4; gradients rtol = 1e-4 + atol = 1e-4 times the
largest |g| of the call (float32
sums over a few hundred steps in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.ops.pallas import chunkwise_v2 as jax_v2
from xlstm_yolo_tpu_torch.ops import chunkwise_v2
from xlstm_yolo_tpu_torch.ops.mlstm_chunkwise import mlstm_siging_chunkwise

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

EPS = 5e-5  # the model's cell eps
CASES = [  # (S, NH, DH, gates, initial states)
    (25, 4, 16, "open", False),      # one ragged chunk (vil-det-tiny's S)
    (128, 2, 32, "perturbed", True),  # two full chunks, initial states (dC0)
    (100, 3, 16, "closed", False),    # ragged second chunk, closed forget gates
    (200, 2, 32, "open", True),       # ragged tail, initial states
    (100, 2, 64, "open", False),      # vil-det-256's head dim, ragged tail
    (130, 1, 128, "perturbed", True),  # vil-det-384's head dim, initial states
]


def make_inputs(seed, B, S, NH, DH, gates, states):
    rng = np.random.default_rng(seed)
    H = NH * DH
    q, k, v = (rng.normal(size=(B, S, H)).astype(np.float32) for _ in range(3))
    if gates == "perturbed":  # the model's init gates, perturbed
        i = rng.uniform(-3, 1, (B, S, NH)).astype(np.float32)
        f = (np.linspace(3, 6, NH) + rng.normal(0, 0.5, (B, S, NH))).astype(np.float32)
    else:
        i = rng.uniform(-6, 4, (B, S, NH)).astype(np.float32)
        lo, hi = (-2, 8) if gates == "open" else (-60, -20)
        f = rng.uniform(lo, hi, (B, S, NH)).astype(np.float32)
    c0 = rng.normal(size=(B, NH, DH, DH)).astype(np.float32) if states else None
    n0 = rng.normal(size=(B, NH, DH)).astype(np.float32) if states else None
    wh = rng.normal(size=(B, S, H)).astype(np.float32)      # upstream dh
    wc = rng.normal(size=(B, NH, DH, DH)).astype(np.float32)  # upstream dC_last
    return [q, k, v, i, f, c0, n0], wh, wc


def jax_grads(args, wh, wc, NH):
    q, k, v, i, f, c0, n0 = (None if a is None else jnp.asarray(a) for a in args)
    states = c0 is not None

    def loss(q, k, v, i, f, c0):
        h, (c_last, _) = jax_v2.mlstm_siging_chunkwise_pallas_v2_bsh(
            q, k, v, i, f, num_heads=NH, chunk_size=64, c_initial=c0,
            n_initial=n0, return_last_states=True, eps=EPS, compute_dtype=jnp.float32)
        return jnp.sum(h * wh) + (jnp.sum(c_last * wc) if states else 0.0), h

    argnums = (0, 1, 2, 3, 4, 5) if states else (0, 1, 2, 3, 4)
    (_, h), g = jax.value_and_grad(loss, argnums=argnums, has_aux=True)(q, k, v, i, f, c0)
    return np.asarray(h), [np.asarray(x) for x in g]


def port_grads(args, wh, wc, NH):
    t = [None if a is None else torch.from_numpy(a).requires_grad_(j != 6)
         for j, a in enumerate(args)]
    q, k, v, i, f, c0, n0 = t
    h, (c_last, _) = chunkwise_v2.mlstm_siging_chunkwise_train(
        q, k, v, i, f, NH, c0, n0, eps=EPS, return_last_states=True)
    loss = (h * torch.from_numpy(wh)).sum()
    if c0 is not None:
        loss = loss + (c_last * torch.from_numpy(wc)).sum()
    leaves = [q, k, v, i, f] + ([c0] if c0 is not None else [])
    return h.detach().numpy(), [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def assert_grads_close(got, ref):
    """atol scales with the largest gradient of the call: di and df are sums
    of q.dq - k.dk terms that cancel (to ~1e-6 with closed forget gates),
    so their rounding is at the scale of those terms, not of the result."""
    scale = max(np.abs(b).max() for b in ref)
    for name, a, b in zip(("dq", "dk", "dv", "di", "df", "dc0"), got, ref):
        assert a.shape == b.shape and np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("variant", ["row", "col"])
@pytest.mark.parametrize("S,NH,DH,gates,states", CASES)
def test_cell_gradients_match_jax_pallas_vjp(S, NH, DH, gates, states, variant, monkeypatch):
    """``col`` runs the JAX backward through ``_bw_fused_kernel_t``."""
    monkeypatch.setattr(jax_v2, "BW_VARIANT", variant)
    args, wh, wc = make_inputs(S + NH, 2, S, NH, DH, gates, states)
    h_ref, g_ref = jax_grads(args, wh, wc, NH)
    h, g = port_grads(args, wh, wc, NH)
    np.testing.assert_allclose(h, h_ref, atol=1e-4, rtol=1e-4)
    assert len(g) == len(g_ref)
    assert_grads_close(g, g_ref)


def cell_grads(fn, args, wh, wc, NH):
    t = [None if a is None else torch.from_numpy(a).requires_grad_(j != 6)
         for j, a in enumerate(args)]
    h, (c_last, _) = fn(*t[:5], NH, t[5], t[6], eps=EPS, return_last_states=True)
    loss = (h * torch.from_numpy(wh)).sum()
    if wc is not None:
        loss = loss + (c_last * torch.from_numpy(wc)).sum()
    leaves = [x for x in t[:6] if x is not None]
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)], c_last.detach().numpy()


@pytest.mark.parametrize("S,NH,DH,gates,states", CASES)
def test_plain_cell_equals_the_function(S, NH, DH, gates, states):
    """The differentiable plain cell (autograd with the denominator
    detached), which stands in for the kernels in float64 references,
    gives the gradients of the Function (train forward + backward)."""
    args, wh, _ = make_inputs(S, 2, S, NH, DH, gates, states)
    got, _ = cell_grads(chunkwise_v2.mlstm_siging_chunkwise_train, args, wh, None, NH)
    ref, _ = cell_grads(chunkwise_v2.mlstm_siging_chunkwise_train_plain, args, wh, None, NH)
    assert_grads_close(got, ref)


def test_function_forget_gradient_omits_the_last_state_term_as_jax_does():
    """With an upstream gradient dC_last of the last state, the JAX VJP
    (and so the Function) takes df = revcumsum(q.dq - k.dk) sigmoid(-f),
    which leaves out the paths that end in C_last: autograd's df is larger
    by sigmoid(-f_t) <dC_last, C_last> at every t.  The model's training
    path never returns states, so this term never arises there."""
    NH = 2
    args, wh, wc = make_inputs(3, 2, 128, NH, 32, "perturbed", True)
    got, c_last = cell_grads(chunkwise_v2.mlstm_siging_chunkwise_train, args, wh, wc, NH)
    ref, _ = cell_grads(chunkwise_v2.mlstm_siging_chunkwise_train_plain, args, wh, wc, NH)
    term = (wc * c_last).sum((-1, -2))[:, None, :] / (1 + np.exp(args[4]))  # (B, S, NH)
    assert np.abs(term).max() > 1e-2 * np.abs(ref[4]).max()
    got[4] = got[4] + term
    assert_grads_close(got, ref)


def test_train_forward_saves_states_and_denominator():
    """The train forward's h equals the inference forward's; the saved
    states chain (C_{c+1} = what the chunk recurrence gives) and end in
    the last states; den >= 1 and is 1 on the rows past S."""
    S, NH, DH = 100, 3, 16
    args, _, _ = make_inputs(1, 2, S, NH, DH, "open", True)
    q, k, v, i, f, c0, n0 = (torch.from_numpy(a) for a in args)
    h, (c_last, n_last), (cs, ns, den) = chunkwise_v2.mlstm_siging_chunkwise_fw_train(
        q, k, v, i, f, NH, c0, n0, eps=EPS)
    h_inf, (c_ref, n_ref) = chunkwise_v2.mlstm_siging_chunkwise_fw(
        q, k, v, i, f, NH, c0, n0, eps=EPS, return_last_states=True)
    torch.testing.assert_close(h, h_inf, atol=0, rtol=0)
    assert cs.shape == (2, 2, NH, DH, DH) and ns.shape == (2, 2, NH, DH)
    assert den.shape == (2, 2, NH, 64)
    torch.testing.assert_close(cs[:, 0], c0)
    torch.testing.assert_close(ns[:, 0], n0)
    _, (c64, n64) = chunkwise_v2.mlstm_siging_chunkwise_fw(
        q[:, :64], k[:, :64], v[:, :64], i[:, :64], f[:, :64], NH, c0, n0, eps=EPS,
        return_last_states=True)
    torch.testing.assert_close(cs[:, 1], c64, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ns[:, 1], n64, atol=1e-4, rtol=1e-4)
    assert (den >= 1).all()
    assert (den[:, 1, :, S - 64:] == 1).all()  # rows 100..127 of chunk 1
    torch.testing.assert_close(c_last, c_ref)


def test_stopgrad_and_autograd_denominators_differ_with_open_gates():
    """The trap: with open gates (|den| > 1 on many rows) the stop-grad
    gradient (the kernel's, at every S) and the gradient through the
    denominator (the JAX package's CPU and S < 1024 path) differ; at the
    default gate init (input-gate bias -10) |den| clamps to 1 and they agree."""
    B, S, NH, DH = 2, 128, 2, 16
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, NH, S, DH)).astype(np.float32))
               for _ in range(3))
    f = torch.from_numpy(rng.uniform(3, 6, (B, NH, S)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(B, NH, S, DH)).astype(np.float32))

    def grad_q(i, stopgrad):
        qq = q.clone().requires_grad_()
        h = mlstm_siging_chunkwise(qq, k, v, i, f, chunk_size=64, eps=EPS,
                                   stopgrad_norm=stopgrad)
        return torch.autograd.grad((h * w).sum(), qq)[0]

    i_open = torch.from_numpy(rng.uniform(0, 4, (B, NH, S)).astype(np.float32))
    assert not torch.allclose(grad_q(i_open, True), grad_q(i_open, False), atol=1e-3)
    i_init = torch.full((B, NH, S), -10.0)
    torch.testing.assert_close(grad_q(i_init, True), grad_q(i_init, False))
