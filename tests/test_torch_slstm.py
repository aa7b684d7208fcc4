"""The sLSTM scan's plain version (``ops/slstm.py`` ``slstm_sequence_plain``,
what CPU tensors take and what the kernel is held against on the card)
against the JAX package's Pallas scan ``slstm_sequence_pallas``, run
interpreted on the CPU, at the shapes the kernel's tiling splits on:

- DH 8, 48 and 128 (one CTA a cluster; a head dim that is no multiple of
  the cluster's 4 CTAs, 12 units each; 8 CTAs of 16 units);
- B 3 and 9 (one group of batch rows, and a ragged second one at G 8);
- with and without an initial state, and with input gates + 12 (m far
  from 0);
- S up to 24, and S 0 (the last state is the initial one).

Inputs are made with numpy from a seed; R has orthonormal columns per
gate and head (not symmetric).  Tolerance: float32 on both sides, sums in
another order: 1e-5 of each output's largest |value|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.ops.pallas.slstm import slstm_sequence_pallas
from xlstm_yolo_tpu_torch.ops import slstm as sl

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

NH = 2
REL = 1e-5


def inputs(seed, B, S, DH, state, big_i):
    rng = np.random.default_rng(seed)
    wx = rng.normal(size=(B, S, 4, NH, DH))
    if big_i:
        wx[:, :, 1] += 12.0
    q, _ = np.linalg.qr(rng.normal(size=(4 * NH * DH, DH)))
    R = q.reshape(4, NH, DH, DH)
    st = None
    if state:
        st = (rng.normal(size=(B, NH, DH)), rng.normal(size=(B, NH, DH)),
              rng.uniform(0.5, 2.0, (B, NH, DH)), rng.uniform(-2.0, 8.0, (B, NH, DH)))
        st = tuple(a.astype(np.float32) for a in st)
    return wx.astype(np.float32), R.astype(np.float32), st


def assert_rel(got, ref, name):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("big_i", [False, True], ids=["gates", "big_i"])
@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("B,S", [(3, 24), (9, 13)])
@pytest.mark.parametrize("DH", [8, 48, 128])
def test_plain_scan_matches_jax_pallas(DH, B, S, state, big_i):
    """hs and the last (h, c, n, m) of the plain scan against JAX's Pallas
    scan (interpreted), within 1e-5 of each output's largest |value|; no
    launch."""
    wx, R, st = inputs(DH + B + 2 * state + big_i, B, S, DH, state, big_i)
    hs_ref, last_ref = slstm_sequence_pallas(
        jnp.asarray(wx), jnp.asarray(R), None if st is None else tuple(map(jnp.asarray, st)))
    before = sl.LAUNCHES
    hs, last = sl.slstm_sequence(torch.from_numpy(wx), torch.from_numpy(R),
                                 None if st is None else tuple(map(torch.from_numpy, st)))
    assert sl.LAUNCHES == before and hs.shape == (B, S, NH * DH)
    assert_rel(hs.numpy(), hs_ref, "hs")
    for name, a, b in zip("hcnm", last, last_ref):
        assert_rel(a.numpy(), b, name)
    if big_i:  # m far from 0, as the case means
        assert last[3].mean().item() > 8.0


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state"])
def test_plain_scan_of_no_steps_returns_the_initial_state(state):
    """S 0: hs is empty and the last state is the initial one (zeros
    without one)."""
    B, DH = 3, 48
    wx, R, st = inputs(5, B, 0, DH, state, False)
    hs, last = sl.slstm_sequence(torch.from_numpy(wx), torch.from_numpy(R),
                                 None if st is None else tuple(map(torch.from_numpy, st)))
    assert hs.shape == (B, 0, NH * DH) and hs.dtype == torch.float32
    want = st if st is not None else (np.zeros((B, NH, DH), np.float32),) * 4
    for a, b in zip(last, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
