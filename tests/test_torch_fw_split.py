"""The v2 forward split in two passes, as its kernels run it on the card:
the state scan (``mlstm_siging_chunkwise_fw_states_plain``), then every
chunk's output alone (``mlstm_siging_chunkwise_fw_out_plain``).  Their
composition is held against the port's one-piece plain forward and
against the JAX package's ``_fw`` (the Pallas ``_fw_kernel_train``,
``_fw_kernel_infer`` and ``_fw_kernel_infer_ln``) run in interpret mode
at the port's chunk of 64 rows.  The kernels themselves are held against
these plain passes on the card in test_torch_kernel_cuda.py.

Inputs are made with numpy from a seed.  Tolerances, on the largest
|difference| of each output over its largest |value| (max_rel): against
the one-piece plain forward 1e-5 (float32; the same function summed in
another order; 9.7e-8 read) and 1e-12 (float64); against JAX with
float32 products 1e-5 (1.1e-6 read).  With bfloat16 products and
bfloat16 q, k, v on both sides, where both round the same operands at
the same points but a float32 sum in another order can flip the rounding
of an operand or of h by one bfloat16 step: max_rel at most 2^-7 (one
step of h's largest value; 7.8e-4 read) and, on the mean |difference|
over the mean |value| (mean_rel), 1e-5 (9.4e-7 read).  Without the
rounding of the products' operands (the same streams in float32, h
rounded to bfloat16 at the end) mean_rel reads 1.1e-3 to 1.6e-3 on h,
so the test also checks that it exceeds 1e-4: a split that skips JAX's
rounding fails.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xlstm_yolo_tpu.ops.pallas import chunkwise_v2 as jax_v2
from xlstm_yolo_tpu_torch.ops import chunkwise_v2

B, NH = 2, 2
EPS = 5e-5  # the model's cell eps
BF16_MAX, BF16_MEAN = 2.0 ** -7, 1e-5


def make_inputs(seed, S, DH, gates, states):
    """(B, S, NH*DH) streams, (B, S, NH) gates far from inert (i ~ U(-6, 4);
    open f ~ U(-2, 8), closed U(-60, -20)), optionally initial states, and
    a LayerNorm's (1 + w, b); numpy float32."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, NH * DH)).astype(np.float32) for _ in range(3))
    i = rng.uniform(-6, 4, (B, S, NH)).astype(np.float32)
    f = rng.uniform(*((-2, 8) if gates == "open" else (-60, -20)), (B, S, NH)).astype(np.float32)
    c0 = rng.normal(size=(B, NH, DH, DH)).astype(np.float32) if states else None
    n0 = rng.normal(size=(B, NH, DH)).astype(np.float32) if states else None
    lnw = (1.0 + 0.3 * rng.normal(size=NH * DH)).astype(np.float32)
    lnb = (0.1 * rng.normal(size=NH * DH)).astype(np.float32)
    return q, k, v, i, f, c0, n0, lnw, lnb


def split(q, k, v, i, f, c0, n0, ln=(None, None)):
    """The two plain passes composed: h, den, c_states, n_states, c_last,
    n_last."""
    cs, ns, (cl, nl) = chunkwise_v2.mlstm_siging_chunkwise_fw_states_plain(k, v, i, f, NH, c0,
                                                                           n0)
    h, den = chunkwise_v2.mlstm_siging_chunkwise_fw_out_plain(q, k, v, i, f, NH, cs, ns,
                                                              eps=EPS, ln_weight=ln[0],
                                                              ln_bias=ln[1])
    return h, den, cs, ns, cl, nl


def max_rel(got, ref, mean=False):
    """The largest |difference| of each output over its largest |ref|, the
    largest over the outputs (``mean``: the mean |difference| over the
    mean |ref|)."""
    out = []
    for a, b in zip(got, ref):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape and np.isfinite(a).all()
        d, b = np.abs(a - b), np.abs(b)
        out.append(d.mean() / max(b.mean(), 1e-30) if mean else d.max() / max(b.max(), 1e-30))
    return max(out)


@pytest.mark.parametrize("S,DH,gates,states,dtype", [
    (25, 16, "open", False, torch.float32),
    (100, 32, "closed", True, torch.float32),
    (200, 16, "open", True, torch.float32),
    (200, 32, "closed", False, torch.float64),
    (100, 16, "open", True, torch.float64),
])
def test_split_matches_the_one_piece_plain_forward(S, DH, gates, states, dtype):
    """h, the last states and the train variant's c_states, n_states and
    den; the LayerNorm variant against the one-piece plain fused forward."""
    acc = dtype if dtype == torch.float64 else torch.float32
    q, k, v, i, f, c0, n0, lnw, lnb = make_inputs(S, S, DH, gates, states)
    t = lambda a, d=acc: None if a is None else torch.from_numpy(a).to(d)  # noqa: E731
    streams = [t(a, dtype) for a in (q, k, v)]
    args = (*streams, t(i), t(f), NH, t(c0), t(n0))
    h, (cl, nl), (cs, ns, den) = chunkwise_v2.mlstm_siging_chunkwise_fw_train_plain(*args,
                                                                                    eps=EPS)
    got = split(*streams, t(i), t(f), t(c0), t(n0))
    ref = (h, den, cs, ns, cl, nl)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert max_rel([a.numpy() for a in got], [a.numpy() for a in ref]) <= tol
    h_ln = chunkwise_v2.mlstm_siging_chunkwise_fw_ln_plain(*args[:6], t(lnw), t(lnb), *args[6:],
                                                           eps=EPS)
    got_ln = split(*streams, t(i), t(f), t(c0), t(n0), ln=(t(lnw), t(lnb)))[0]
    assert max_rel([got_ln.numpy()], [h_ln.numpy()]) <= tol


JAX_CASES = [  # (S, DH, gates, initial states, compute type): ragged S, both head dims
    (25, 16, "open", False, "float32"),
    (100, 32, "closed", True, "float32"),
    (200, 16, "open", True, "float32"),
    (25, 16, "open", False, "bfloat16"),
    (100, 32, "closed", True, "bfloat16"),
    (200, 16, "open", True, "bfloat16"),
    (200, 32, "closed", False, "bfloat16"),
    (100, 16, "open", False, "bfloat16"),
]


@pytest.mark.parametrize("S,DH,gates,states,compute", JAX_CASES,
                         ids=[f"S{c[0]}-dh{c[1]}-{c[2]}-init{int(c[3])}-{c[4]}"
                              for c in JAX_CASES])
def test_split_matches_jax_fw(S, DH, gates, states, compute):
    """JAX's ``_fw`` at L 64 in its three variants: the train variant (h,
    den, c_states, c_last, n_last), the inference variant (h) and the
    inference variant with the LayerNorm fused in (h); q, k, v in the
    compute type on both sides (the port rounds to q's dtype).  With
    bfloat16, the same streams in float32 (no rounding of the products'
    operands, h rounded to bfloat16 at the end) must miss the tolerance."""
    q, k, v, i, f, c0, n0, lnw, lnb = make_inputs(S + DH, S, DH, gates, states)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    tdt, jdt = getattr(torch, compute), getattr(jnp, compute)
    streams = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    js = [jnp.asarray(a.float().numpy()).astype(jdt) for a in streams]
    kw = dict(chunk_size=chunkwise_v2.CHUNK_SIZE, eps=EPS, compute_dtype=jdt)
    jh, jden, jcs, jcl, jnl = jax_v2._fw(*js, j(i), j(f), NH, j(c0), j(n0), save_states=True,
                                         **kw)
    jh_inf = jax_v2._fw(*js, j(i), j(f), NH, j(c0), j(n0), save_states=False, **kw)[0]
    jh_ln = jax_v2._fw(*js, j(i), j(f), NH, j(c0), j(n0), save_states=False, ln_weight=j(lnw),
                       ln_bias=j(lnb), **kw)[0]
    ref = [np.asarray(a, np.float32) for a in (jh, jden, jcs, jcl, jnl, jh_inf, jh_ln)]

    def port(x):
        h, den, cs, _, cl, nl = split(*x, t(i), t(f), t(c0), t(n0))
        h_ln = split(*x, t(i), t(f), t(c0), t(n0), ln=(t(lnw), t(lnb)))[0]
        r = lambda a: a.to(tdt).float().numpy()  # noqa: E731  h in the compute type
        return [r(h), den.numpy(), cs.numpy(), cl.numpy(), nl.numpy(), r(h), r(h_ln)]

    got = port(streams)
    if compute == "float32":
        assert max_rel(got, ref) <= 1e-5
        return
    assert max_rel(got, ref) <= BF16_MAX and max_rel(got, ref, mean=True) <= BF16_MEAN
    assert max_rel(port([a.float() for a in streams]), ref, mean=True) > 10 * BF16_MEAN


def test_forward_wrappers_take_the_plain_passes_on_the_cpu():
    """The pass wrappers run their plain versions on CPU tensors with no
    launch counted, and each forward wrapper its one-piece plain version."""
    q, k, v, i, f, c0, n0, lnw, lnb = (torch.from_numpy(a)
                                       for a in make_inputs(3, 100, 16, "open", True))
    before = (chunkwise_v2.LAUNCHES, chunkwise_v2.LAUNCHES_TRAIN, chunkwise_v2.LAUNCHES_LN)
    for save in (True, False):
        got = chunkwise_v2.mlstm_siging_chunkwise_fw_states(k, v, i, f, NH, c0, n0,
                                                            save_states=save)
        ref = chunkwise_v2.mlstm_siging_chunkwise_fw_states_plain(k, v, i, f, NH, c0, n0)
        assert all(torch.equal(a, b) for a, b in zip([*got[:2], *got[2]], [*ref[:2], *ref[2]]))
    cs, ns = ref[:2]
    for ln in ((None, None), (lnw, lnb)):
        got = chunkwise_v2.mlstm_siging_chunkwise_fw_out(q, k, v, i, f, NH, cs, ns, eps=EPS,
                                                         ln_weight=ln[0], ln_bias=ln[1])
        ref = chunkwise_v2.mlstm_siging_chunkwise_fw_out_plain(q, k, v, i, f, NH, cs, ns,
                                                               eps=EPS, ln_weight=ln[0],
                                                               ln_bias=ln[1])
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    h = chunkwise_v2.mlstm_siging_chunkwise_fw(q, k, v, i, f, NH, c0, n0, eps=EPS)
    assert torch.equal(h, chunkwise_v2.mlstm_siging_chunkwise_fw_plain(q, k, v, i, f, NH, c0, n0,
                                                                       eps=EPS))
    assert (chunkwise_v2.LAUNCHES, chunkwise_v2.LAUNCHES_TRAIN,
            chunkwise_v2.LAUNCHES_LN) == before


def test_kernel_wrappers_take_row_strided_streams():
    """q, k and v may be views with a row stride (the cell's split of one
    projection), but not with a last dim that is not contiguous."""
    q, k, v, i, f, c0, n0, _, _ = (torch.from_numpy(a) if a is not None else None
                                   for a in make_inputs(4, 100, 16, "open", True))
    qk = torch.cat([q, k], -1)
    qv, kv = qk.split(NH * 16, -1)
    assert not qv.is_contiguous()
    got = chunkwise_v2.mlstm_siging_chunkwise_fw(qv, kv, v, i, f, NH, c0, n0, eps=EPS)
    assert torch.equal(got, chunkwise_v2.mlstm_siging_chunkwise_fw(q, k, v, i, f, NH, c0, n0,
                                                                   eps=EPS))
    meta = [a.to("meta") for a in (qk, v, i, f)]
    with pytest.raises(ValueError, match="layout"):
        chunkwise_v2.mlstm_siging_chunkwise_fw(meta[0][..., ::2], meta[0][..., 1::2], meta[1],
                                               meta[2], meta[3], NH)
