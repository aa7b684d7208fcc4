"""The port's chunkwise mLSTM (the plain PyTorch version, which the kernel
wrapper runs on CPU tensors) held against the JAX package: the v2 Pallas
forward in interpret mode, the jnp chunkwise scan, and the step-by-step
recurrences.  The kernel itself is held against this plain version on the
card in test_torch_kernel_cuda.py.

Inputs are made with numpy from a seed; all comparisons are float32.
Tolerance: atol = rtol = 1e-4 (float32 sums taken in another order over
at most a few hundred steps; |h| stays below ~20 here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.ops.mlstm_chunkwise import mlstm_siging_chunkwise as jax_chunkwise
from xlstm_yolo_tpu.ops.mlstm_recurrent import mlstm_siging_recurrent_sequence as jax_recurrent
from xlstm_yolo_tpu.ops.pallas.chunkwise_v2 import mlstm_siging_chunkwise_pallas_v2_bsh
from xlstm_yolo_tpu_torch.ops import chunkwise_v2
from xlstm_yolo_tpu_torch.ops.mlstm_chunkwise import mlstm_siging_chunkwise
from xlstm_yolo_tpu_torch.ops.mlstm_recurrent import mlstm_siging_recurrent_sequence

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

TOL = dict(atol=1e-4, rtol=1e-4)
EPS = 5e-5  # the model's cell eps


def make_inputs(seed, B, S, NH, DH, gates="open", states=False):
    """(B, S, H) streams, (B, S, NH) gates and optional states, numpy f32.

    ``open`` gates keep the cell far from inert (at the init bias i = -10
    the output is ~e^-10 and a wrong kernel would pass); ``closed`` drives
    the forget gates to logsig(f) ~ -40 per step.
    """
    rng = np.random.default_rng(seed)
    H = NH * DH
    q, k, v = (rng.normal(size=(B, S, H)).astype(np.float32) for _ in range(3))
    i = rng.uniform(-6, 4, (B, S, NH)).astype(np.float32)
    if gates == "open":
        f = rng.uniform(-2, 8, (B, S, NH)).astype(np.float32)
    else:
        f = rng.uniform(-60, -20, (B, S, NH)).astype(np.float32)
    c0 = rng.normal(size=(B, NH, DH, DH)).astype(np.float32) if states else None
    n0 = rng.normal(size=(B, NH, DH)).astype(np.float32) if states else None
    return q, k, v, i, f, c0, n0


def port_fw(q, k, v, i, f, c0, n0, NH):
    t = lambda a: None if a is None else torch.from_numpy(a)
    h, (c, n) = chunkwise_v2.mlstm_siging_chunkwise_fw(
        t(q), t(k), t(v), t(i), t(f), NH, t(c0), t(n0), eps=EPS, return_last_states=True)
    return h.numpy(), c.numpy(), n.numpy()


CASES = [  # (S, NH, DH, gates, states)
    (25, 4, 16, "open", False),    # single ragged chunk (vil-det-tiny's S)
    (64, 2, 32, "open", True),     # exactly one chunk, with initial states
    (100, 3, 16, "closed", False),  # ragged second chunk, closed forget gates
    (200, 4, 32, "open", True),    # several chunks, ragged tail
    (130, 2, 64, "open", True),    # vil-det-256's head dim
    (200, 1, 128, "closed", False),  # vil-det-384's head dim, closed forget gates
    (70, 1, 128, "open", True),    # vil-det-384's head dim, ragged second chunk
]


@pytest.mark.parametrize("S,NH,DH,gates,states", CASES)
def test_plain_matches_jax_pallas_v2(S, NH, DH, gates, states):
    B = 2
    q, k, v, i, f, c0, n0 = make_inputs(S, B, S, NH, DH, gates, states)
    h, c, n = port_fw(q, k, v, i, f, c0, n0, NH)
    out = mlstm_siging_chunkwise_pallas_v2_bsh(
        *(jnp.asarray(a) for a in (q, k, v, i, f)), num_heads=NH,
        c_initial=None if c0 is None else jnp.asarray(c0),
        n_initial=None if n0 is None else jnp.asarray(n0),
        return_last_states=True, eps=EPS, compute_dtype=jnp.float32)
    h_ref, (c_ref, n_ref) = out
    assert np.isfinite(h).all()
    np.testing.assert_allclose(h, np.asarray(h_ref), **TOL)
    np.testing.assert_allclose(c, np.asarray(c_ref), **TOL)
    np.testing.assert_allclose(n, np.asarray(n_ref), **TOL)


@pytest.mark.parametrize("S,NH,DH,gates,states", CASES)
def test_plain_matches_jax_scan_and_recurrences(S, NH, DH, gates, states):
    """Heads layout (B, NH, S, DH): the port's chunkwise form against the
    JAX chunkwise scan (chunk = S, its divisibility rule) and against both
    step-by-step recurrences."""
    B = 2
    q, k, v, i, f, c0, n0 = make_inputs(S + 1, B, S, NH, DH, gates, states)
    heads = lambda a: a.reshape(B, S, NH, DH).transpose(0, 2, 1, 3)
    qh, kh, vh = heads(q), heads(k), heads(v)
    ih, fh = i.transpose(0, 2, 1), f.transpose(0, 2, 1)
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    h, (c, n) = mlstm_siging_chunkwise(t(qh), t(kh), t(vh), t(ih), t(fh), chunk_size=16,
                                       c_initial=t(c0), n_initial=t(n0), eps=EPS,
                                       return_last_states=True)
    h_rec, (c_rec, n_rec) = mlstm_siging_recurrent_sequence(
        t(qh), t(kh), t(vh), t(ih), t(fh), t(c0), t(n0), eps=EPS, return_last_states=True)
    j = lambda a: None if a is None else jnp.asarray(a)
    h_scan, (c_scan, n_scan) = jax_chunkwise(j(qh), j(kh), j(vh), j(ih), j(fh), chunk_size=S,
                                             c_initial=j(c0), n_initial=j(n0), eps=EPS,
                                             return_last_states=True)
    h_jrec, (c_jrec, n_jrec) = jax_recurrent(j(qh), j(kh), j(vh), j(ih), j(fh), j(c0), j(n0),
                                             eps=EPS, return_last_states=True)
    for ref in (h_rec.numpy(), np.asarray(h_scan), np.asarray(h_jrec)):
        np.testing.assert_allclose(h.numpy(), ref, **TOL)
    for ref_c, ref_n in ((c_rec.numpy(), n_rec.numpy()), (c_scan, n_scan), (c_jrec, n_jrec)):
        np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), **TOL)
        np.testing.assert_allclose(n.numpy(), np.asarray(ref_n), **TOL)


def test_state_threading_equals_one_pass():
    """Two calls threading (C, n) equal one call over the whole sequence."""
    B, S, NH, DH = 2, 150, 3, 16
    q, k, v, i, f, _, _ = make_inputs(7, B, S, NH, DH)
    h, c, n = port_fw(q, k, v, i, f, None, None, NH)
    cut = 70
    h1, c1, n1 = port_fw(q[:, :cut], k[:, :cut], v[:, :cut], i[:, :cut], f[:, :cut],
                         None, None, NH)
    h2, c2, n2 = port_fw(q[:, cut:], k[:, cut:], v[:, cut:], i[:, cut:], f[:, cut:],
                         c1, n1, NH)
    np.testing.assert_allclose(np.concatenate([h1, h2], 1), h, **TOL)
    np.testing.assert_allclose(c2, c, **TOL)
    np.testing.assert_allclose(n2, n, **TOL)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 64)
    gates = torch.zeros(1, 8, 2)
    assert chunkwise_v2.mlstm_siging_chunkwise_fw(q, q, q, gates, gates, 2).shape == q.shape
    with pytest.raises(ValueError):
        chunkwise_v2.mlstm_siging_chunkwise_fw(q, q[:, :4], q, gates, gates, 2)
    with pytest.raises(ValueError):
        chunkwise_v2.mlstm_siging_chunkwise_fw(q, q, q, gates, gates, 4)  # DH = 16 ok, NH != 2
    with pytest.raises(ValueError):
        chunkwise_v2.mlstm_siging_chunkwise_fw(q, q, q, gates.double(), gates, 2)
    with pytest.raises(ValueError):
        chunkwise_v2.mlstm_siging_chunkwise_fw(q, q, q, gates, gates, 2,
                                               c_initial=torch.zeros(1, 2, 32, 32))
