"""The v2 inference forward with the per-head LayerNorm fused in: the
port's plain version (``ops/chunkwise_v2.py``
``mlstm_siging_chunkwise_fw_ln_plain``, which the wrapper runs on CPU
tensors) against the JAX package's Pallas entry with ``ln_weight`` and
``ln_bias`` (``_fw_kernel_infer_ln``), interpreted on the CPU; and the
port's ``MatrixLSTMCell(fuse_outnorm=True)`` against JAX's, with the same
weights.  The CUDA kernel is held against the plain version on the card
(``test_torch_kernel_cuda.py``, ``chip_smoke.py`` outnorm).

Inputs are made with numpy from a seed.  v is offset by 20, so that each
row of h has |mean| >> std, where a raw-moment variance would cancel.
Tolerances, relative to each output's largest |value| (atol) and rtol:
float32 1e-4 (float32 sums in another order; the normalisation divides
h's rounding by its row's std); bfloat16 streams 2e-2 (both sides widen
q, k, v to float32, normalise the float32 h and round the output once, a
bfloat16 step of 2^-8).  The cells: 2e-4, as ``test_torch_layers.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_layers import randomize
from xlstm_yolo_tpu.nn import layers as jl
from xlstm_yolo_tpu.ops.pallas.chunkwise_v2 import mlstm_siging_chunkwise_pallas_v2_bsh
from xlstm_yolo_tpu_torch.nn import layers as tl
from xlstm_yolo_tpu_torch.ops import chunkwise_v2
from xlstm_yolo_tpu_torch.utils.convert import jax_variables_to_state_dict

EPS = 5e-5  # the model's cell eps
V2 = "chunkwise--pallas_xl_chunk_siging_v2"
REL = {"float32": 1e-4, "bfloat16": 2e-2}


def make_inputs(seed, B, S, NH, DH, states):
    rng = np.random.default_rng(seed)
    H = NH * DH
    q, k = (rng.normal(size=(B, S, H)).astype(np.float32) for _ in range(2))
    v = (20.0 + rng.normal(size=(B, S, H))).astype(np.float32)  # |mean| >> std rows of h
    i = rng.uniform(-6, 4, (B, S, NH)).astype(np.float32)
    f = rng.uniform(-2, 8, (B, S, NH)).astype(np.float32)
    w = rng.normal(0, 0.3, H).astype(np.float32)
    b = rng.normal(0, 0.1, H).astype(np.float32)
    c0 = rng.normal(size=(B, NH, DH, DH)).astype(np.float32) if states else None
    n0 = rng.normal(size=(B, NH, DH)).astype(np.float32) if states else None
    return [q, k, v, i, f], w, b, c0, n0


def assert_rel_close(got, ref, rel, name):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("S,NH,DH,dtype,states", [
    (64, 4, 32, "float32", False),    # one chunk in both packages
    (200, 2, 32, "bfloat16", True),   # ragged: four chunks of the port's 64
    (64, 1, 128, "float32", True),    # vil-det-384's head dim, one chunk
    (150, 2, 128, "float32", False),  # vil-det-384's head dim, ragged
    (150, 1, 128, "bfloat16", True),
])
def test_plain_fused_forward_matches_jax_pallas_ln_entry(S, NH, DH, dtype, states):
    """h (normalised, in the stream dtype) and the last (C, n) against
    ``mlstm_siging_chunkwise_pallas_v2_bsh(..., ln_weight=1 + w, ln_bias=b)``
    with float32 products, and every row whose variance is well above
    ln_eps normalised: mean b, scale 1 + w."""
    B = 2
    streams, w, b, c0, n0 = make_inputs(S * DH, B, S, NH, DH, states)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt if j < 3 else jnp.float32) for j, a in enumerate(streams)]
    targs = [torch.from_numpy(a).to(tdt if j < 3 else torch.float32)
             for j, a in enumerate(streams)]
    opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    h_ref, (c_ref, n_ref) = mlstm_siging_chunkwise_pallas_v2_bsh(
        *jargs, num_heads=NH, c_initial=opt(c0), n_initial=opt(n0), return_last_states=True,
        eps=EPS, compute_dtype=jnp.float32, ln_weight=jnp.asarray(1.0 + w),
        ln_bias=jnp.asarray(b))
    topt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    lnw, lnb = torch.from_numpy(1.0 + w), torch.from_numpy(b)
    before = chunkwise_v2.LAUNCHES_LN
    h, (c, n) = chunkwise_v2.mlstm_siging_chunkwise_fw_ln(
        *targs, NH, lnw, lnb, topt(c0), topt(n0), eps=EPS, return_last_states=True)
    assert chunkwise_v2.LAUNCHES_LN == before  # the plain version on the CPU
    assert h.dtype == tdt
    assert_rel_close(h.float(), np.asarray(h_ref, np.float32), REL[dtype], "h")
    assert_rel_close(c, c_ref, 1e-4, "C")
    assert_rel_close(n, n_ref, 1e-4, "n")
    raw = chunkwise_v2.mlstm_siging_chunkwise_fw_plain(*[t.float() for t in targs], NH,
                                                       topt(c0), topt(n0), eps=EPS)
    hh = raw.reshape(B, S, NH, DH)
    assert (hh.mean(-1).abs() > 5 * hh.std(-1)).float().mean() > 0.5  # |mean| >> std
    y = ((h.float() - lnb) / lnw).reshape(B, S, NH, DH)
    rows = hh.var(-1, unbiased=False) > 1e-3  # well above ln_eps = 1e-6
    tol = 1e-3 if dtype == "float32" else 5e-2
    assert rows.float().mean() > 0.5
    assert y.mean(-1)[rows].abs().max() < tol
    assert (y.square().mean(-1)[rows] - 1).abs().max() < tol


def test_fused_forward_refuses_what_the_kernel_does_not_take():
    streams, w, b, _, _ = make_inputs(0, 1, 16, 2, 48, False)
    t = [torch.from_numpy(a) for a in streams]
    lnw = torch.from_numpy(1.0 + w)
    with pytest.raises(ValueError, match="ln_weight is required"):
        chunkwise_v2.mlstm_siging_chunkwise_fw_ln(*t, 2, None)
    with pytest.raises(ValueError, match="ln_bias must be"):
        chunkwise_v2.mlstm_siging_chunkwise_fw_ln(*t, 2, lnw, torch.zeros(5))
    with pytest.raises(ValueError, match="head dim 48 not supported"):
        chunkwise_v2.mlstm_siging_chunkwise_fw_ln(*(a.to("meta") for a in t), 2,
                                                  lnw.to("meta"))


@pytest.mark.parametrize("states", [False, True], ids=["stateless", "stateful"])
def test_fused_cell_matches_jax(states):
    """``MatrixLSTMCell(fuse_outnorm=True)`` in eval against JAX's (v2 name,
    ``mode="inference"``) at S = 1024, where JAX takes the fused kernel
    (chunk 256); every weight ~ 0.2 N(0, 1), the outnorm's included; with a
    state the cells also return (C, n).  The unfused port cell gives the
    same output on the CPU (both normalise the float32 h there)."""
    dim, NH, S = 64, 2, 1024
    rng = np.random.default_rng(21)
    x = [rng.normal(size=(1, S, dim)).astype(np.float32) for _ in range(3)]
    jm = jl.MatrixLSTMCell(dim=dim, num_heads=NH, chunk_size=256, mode="inference",
                           fuse_outnorm=True, chunkwise_kernel=V2)
    variables = randomize(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), *(jnp.asarray(a[:, :8]) for a in x))), rng)
    DH = dim // NH
    state = ([rng.normal(size=(1, NH, DH, DH)).astype(np.float32),
              rng.normal(size=(1, NH, DH)).astype(np.float32)] if states else None)
    jout = jm.apply(variables, *map(jnp.asarray, x),
                    **({"state": tuple(map(jnp.asarray, state))} if states else {}))
    pm = tl.MatrixLSTMCell(dim, NH, fuse_outnorm=True)
    pm.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    plain = tl.MatrixLSTMCell(dim, NH)
    plain.load_state_dict(pm.state_dict(), strict=True)
    kw = {"state": tuple(map(torch.from_numpy, state))} if states else {}
    with torch.no_grad():
        out = pm.eval()(*map(torch.from_numpy, x), **kw)
        unfused = plain.eval()(*map(torch.from_numpy, x), **kw)
    h, h_ref = (out[0], jout[0]) if states else (out, jout)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(h.numpy(), (unfused[0] if states else unfused).numpy(),
                               atol=2e-4, rtol=2e-4)
    if states:
        for a, b in zip(out[1], jout[1]):
            assert_rel_close(a.numpy(), np.asarray(b), 1e-4, "state")
