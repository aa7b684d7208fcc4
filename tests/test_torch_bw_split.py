"""The v2 backward split in two passes, as its bfloat16 kernels run it on
the card: the dC scan (``mlstm_siging_chunkwise_bw_dc_plain``), then dq,
dk, dv of every chunk alone (``mlstm_siging_chunkwise_bw_dqkv_plain``).
Their composition is held against the port's one-piece plain backward
(autograd through the plain forward, the denominator held constant) and
against the JAX package's ``_bw`` (the Pallas ``_bw_fused_kernel``) run in
interpret mode, both sides given the same saved states and denominators.
The kernels themselves are held against these plain passes on the card in
test_torch_kernel_cuda.py.

Inputs are made with numpy from a seed.  Tolerances, on the largest
|difference| of each output over its largest |value|: against the
one-piece plain backward 1e-5 (float32; the same function summed in
another order) and 1e-12 (float64); against JAX with float32 products
1e-4 (float32 sums over up to S rows in another order; 1.1e-6 read); with
bfloat16 products and bfloat16 q, k, v, dh on both sides 4e-4 (both round
the same operands at the same points; 7.1e-6 read, where one float32 sum
in another order flipped an operand's rounding by one bfloat16 step),
under a third of what rounding the products' operands moves (1.4e-3 to
7.1e-3 from JAX with the operands kept in float32), so the test also
checks that the split without that rounding fails.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.ops.pallas import chunkwise_v2 as jax_v2
from xlstm_yolo_tpu_torch.ops import chunkwise_v2

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin

B, NH = 2, 2
EPS = 5e-5  # the model's cell eps


def make_inputs(seed, S, DH, gates, dc_last):
    """(B, S, NH*DH) streams and upstream dh, (B, S, NH) gates far from
    inert (i ~ U(-6, 4); open f ~ U(-2, 8), closed U(-60, -20)), initial
    states and optionally dC_last; numpy float32."""
    rng = np.random.default_rng(seed)
    q, k, v, dh = (rng.normal(size=(B, S, NH * DH)).astype(np.float32) for _ in range(4))
    i = rng.uniform(-6, 4, (B, S, NH)).astype(np.float32)
    f = rng.uniform(*((-2, 8) if gates == "open" else (-60, -20)), (B, S, NH)).astype(np.float32)
    c0 = rng.normal(size=(B, NH, DH, DH)).astype(np.float32)
    n0 = rng.normal(size=(B, NH, DH)).astype(np.float32)
    dcl = rng.normal(size=(B, NH, DH, DH)).astype(np.float32) if dc_last else None
    return q, k, v, i, f, c0, n0, dh, dcl


def split(q, k, v, i, f, cs, den, dh, dcl):
    """The two plain passes composed: dq, dk, dv, dC0."""
    dcs, dc0 = chunkwise_v2.mlstm_siging_chunkwise_bw_dc_plain(q, f, NH, den, dh, dcl, eps=EPS)
    return (*chunkwise_v2.mlstm_siging_chunkwise_bw_dqkv_plain(q, k, v, i, f, NH, cs, den, dh,
                                                               dcs, eps=EPS), dc0)


def max_rel(got, ref):
    """The largest |difference| of dq, dk, dv and dC0 over its largest |ref|."""
    out = []
    for a, b in zip(got, ref):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.isfinite(a).all()
        out.append(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    return max(out)


@pytest.mark.parametrize("S,DH,gates,dc_last,dtype", [
    (100, 16, "open", True, torch.float32),
    (200, 32, "closed", False, torch.float32),
    (130, 32, "open", True, torch.float64),
    (64, 16, "closed", True, torch.float64),
])
def test_split_matches_the_one_piece_plain_backward(S, DH, gates, dc_last, dtype):
    q, k, v, i, f, c0, n0, dh, dcl = (None if a is None else torch.from_numpy(a).to(dtype)
                                      for a in make_inputs(S, S, DH, gates, dc_last))
    _, _, (cs, _, den) = chunkwise_v2.mlstm_siging_chunkwise_fw_train_plain(
        q, k, v, i, f, NH, c0, n0, eps=EPS)
    ref = chunkwise_v2.mlstm_siging_chunkwise_bw_plain(q, k, v, i, f, NH, cs, den, dh, dcl,
                                                       eps=EPS)
    got = split(q, k, v, i, f, cs, den, dh, dcl)
    assert max_rel([t.numpy() for t in got], [t.numpy() for t in ref]) <= (
        1e-5 if dtype == torch.float32 else 1e-12)


JAX_CASES = [  # (S, DH, gates, dC_last, compute type): ragged S, both head dims
    (100, 16, "open", True, "float32"),
    (200, 32, "closed", False, "float32"),
    (100, 32, "closed", True, "float32"),
    (200, 16, "open", False, "float32"),
    (100, 16, "closed", True, "bfloat16"),
    (200, 32, "open", False, "bfloat16"),
    (200, 16, "closed", False, "bfloat16"),
    (100, 32, "open", True, "bfloat16"),
]


@pytest.mark.parametrize("S,DH,gates,dc_last,compute", JAX_CASES,
                         ids=[f"S{c[0]}-dh{c[1]}-{c[2]}-dcl{int(c[3])}-{c[4]}" for c in JAX_CASES])
def test_split_matches_jax_bw(S, DH, gates, dc_last, compute):
    """JAX's ``_bw`` at L 64 with the port's saved states; q, k, v, dh in
    the compute type on both sides (the port rounds to q's dtype).  With
    bfloat16, the same streams in float32 (no rounding of the products'
    operands) must miss the tolerance."""
    q, k, v, i, f, c0, n0, dh, dcl = make_inputs(S + DH, S, DH, gates, dc_last)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    _, _, (cs, _, den) = chunkwise_v2.mlstm_siging_chunkwise_fw_train_plain(
        *map(t, (q, k, v, i, f)), NH, t(c0), t(n0), eps=EPS)
    tdt, jdt = getattr(torch, compute), getattr(jnp, compute)
    streams = [torch.from_numpy(a).to(tdt) for a in (q, k, v, dh)]
    got = split(*streams[:3], t(i), t(f), cs, den, streams[3], t(dcl))
    js = [jnp.asarray(a.float().numpy()).astype(jdt) for a in streams]
    ref = jax_v2._bw(*js[:3], jnp.asarray(i), jnp.asarray(f), NH, jnp.asarray(den.numpy()),
                     jnp.asarray(cs.numpy()), js[3], None if dcl is None else jnp.asarray(dcl),
                     chunk_size=chunkwise_v2.CHUNK_SIZE, eps=EPS, compute_dtype=jdt)
    ref = [np.asarray(a, np.float32) for a in (ref[0], ref[1], ref[2], ref[5])]
    tol = 1e-4 if compute == "float32" else 4e-4
    assert max_rel([a.float().numpy() for a in got], ref) <= tol
    if compute == "bfloat16":
        unrounded = split(*(a.float() for a in streams[:3]), t(i), t(f), cs, den,
                          streams[3].float(), t(dcl))
        assert max_rel([a.numpy() for a in unrounded], ref) > 3 * tol


def test_pass_wrappers_take_the_plain_passes_on_the_cpu():
    """The per-pass wrappers run their plain versions on CPU tensors, and
    the backward's wrapper its one-piece plain version, with no launch
    counted."""
    q, k, v, i, f, c0, n0, dh, dcl = (None if a is None else torch.from_numpy(a)
                                      for a in make_inputs(3, 100, 16, "open", True))
    _, _, (cs, _, den) = chunkwise_v2.mlstm_siging_chunkwise_fw_train_plain(
        q, k, v, i, f, NH, c0, n0, eps=EPS)
    before = chunkwise_v2.LAUNCHES_BW
    dcs, dc0 = chunkwise_v2.mlstm_siging_chunkwise_bw_dc(q, f, NH, den, dh, dcl, eps=EPS)
    rdcs, rdc0 = chunkwise_v2.mlstm_siging_chunkwise_bw_dc_plain(q, f, NH, den, dh, dcl, eps=EPS)
    assert torch.equal(dcs, rdcs) and torch.equal(dc0, rdc0)
    got = chunkwise_v2.mlstm_siging_chunkwise_bw_dqkv(q, k, v, i, f, NH, cs, den, dh, dcs,
                                                      eps=EPS)
    ref = chunkwise_v2.mlstm_siging_chunkwise_bw_dqkv_plain(q, k, v, i, f, NH, cs, den, dh, dcs,
                                                            eps=EPS)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    whole = chunkwise_v2.mlstm_siging_chunkwise_bw(q, k, v, i, f, NH, cs, den, dh, dcl, eps=EPS)
    plain = chunkwise_v2.mlstm_siging_chunkwise_bw_plain(q, k, v, i, f, NH, cs, den, dh, dcl,
                                                         eps=EPS)
    assert all(torch.equal(a, b) for a, b in zip(whole, plain))
    assert chunkwise_v2.LAUNCHES_BW == before
