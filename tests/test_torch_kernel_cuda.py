"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the chunkwise mLSTM inference forward (also with the per-head LayerNorm
fused in), train forward and backward (and the differentiable cell built
from them), the epilogue backward, the FFN
backward, the v1 and exp routes' forward, dC scan and dq/dk/dv kernels
at every chunk length, the quadratic forward, dq and dk/dv kernels, and the
one-token step, at head dims 16 and 32 (the flagship, vil-det-tiny), 64
(vil-det-256) and 128 (vil-det-384), and the row kernels at all their
widths.  This file imports neither JAX nor the JAX package, so it
runs on the GPU machine:

    python -m pytest -m cuda tests/test_torch_kernel_cuda.py -q

Without a CUDA device its tests skip.  Inputs are made with numpy from a
seed.  Tolerances:

- float32: atol = rtol = 1e-4 for forward values (sums in another order);
  gradients atol = 1e-4 times the largest |g| of the output, rtol = 1e-4
  (the backward sums over up to S rows in another order);
- bfloat16 inputs (both sides see the same rounded values): atol = rtol =
  2e-2 for h; gradients atol = 2e-2 times the largest |g|, rtol = 2e-2 (the
  kernels keep float32 where the plain version rounds intermediate products
  to bfloat16, and round each output once);
- the v1 and exp kernels round the operands of their products to the
  compute type at the same points as their plain versions: each output
  within 1e-4 of its largest |value| with compute float32, 2e-2 with compute
  bfloat16 (a float32 sum in another order can flip the rounding of an
  operand by one bfloat16 step).  The exp forward's h is held as its
  numerator h (den + eps) beside den: the floor e^{-m_comb} of its
  denominator is tiny once m is large, so a row whose terms nearly cancel
  turns a float32 rounding of den into a large relative change of h.
"""

import numpy as np
import pytest
import torch

from xlstm_yolo_tpu_torch.ops import chunkwise as v1
from xlstm_yolo_tpu_torch.ops import chunkwise_exp as exp
from xlstm_yolo_tpu_torch.ops import chunkwise_v2, epilogue, ffn, step
from xlstm_yolo_tpu_torch.ops import parallel as par
from xlstm_yolo_tpu_torch.ops.mlstm_recurrent import mlstm_siging_step

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
EPS = 5e-5  # the model's cell eps
CASES = [  # (S, NH, DH, gates, initial states)
    (25, 4, 16, "open", False),     # single ragged chunk (vil-det-tiny's S)
    (64, 2, 32, "open", True),      # exactly one chunk, with initial states
    (100, 3, 16, "closed", False),  # ragged second chunk, closed forget gates
    (200, 4, 32, "open", True),     # several chunks, ragged tail
    (1000, 12, 32, "open", True),   # flagship heads, ragged S
    (300, 8, 64, "open", True),     # vil-det-256's heads, ragged S
    (200, 6, 128, "closed", True),  # vil-det-384's heads, closed forget gates
    (1000, 6, 128, "open", False),  # vil-det-384's heads, ragged S
]
ROW_CASES = [  # (B, S, H, D, U, NH, mean offset): epilogue H, NH; FFN D, U
    (2, 25, 64, 32, 96, 4, 0.0),        # one ragged row tile
    (2, 100, 384, 192, 512, 12, 0.0),   # the flagship's widths, ragged tiles
    (1, 1000, 384, 192, 512, 12, 50.0),  # |mean| >> std rows (centred variance)
    (2, 100, 512, 256, 704, 8, 0.0),     # vil-det-256's widths (FFN: 16-row tiles)
    (1, 300, 768, 384, 1024, 6, 50.0),   # vil-det-384's widths (both 16-row tiles)
]


def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def make_inputs(seed, B, S, NH, DH, gates, states):
    """(B, S, H) streams, (B, S, NH) gates far from inert (i ~ U(-6, 4);
    open f ~ U(-2, 8), closed f ~ U(-60, -20)), optional states."""
    rng = np.random.default_rng(seed)
    H = NH * DH
    q, k, v = (rng.normal(size=(B, S, H)).astype(np.float32) for _ in range(3))
    i = rng.uniform(-6, 4, (B, S, NH)).astype(np.float32)
    f = rng.uniform(*((-2, 8) if gates == "open" else (-60, -20)), (B, S, NH)).astype(np.float32)
    c0 = rng.normal(size=(B, NH, DH, DH)).astype(np.float32) if states else None
    n0 = rng.normal(size=(B, NH, DH)).astype(np.float32) if states else None
    return q, k, v, i, f, c0, n0


def cu(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a)).to("cuda", dtype)


def assert_grads_close(got, ref, dtype):
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, ref):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all()
        scale = max(b.abs().max().item(), 1e-30)
        torch.testing.assert_close(a, b, atol=rel * scale, rtol=rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_gpu(dtype):
    needs_cuda()
    dt = getattr(torch, dtype)
    tol = TOL if dt == torch.float32 else BF16_TOL
    for S, NH, DH, gates, states in CASES:
        q, k, v, i, f, c0, n0 = make_inputs(S, 2, S, NH, DH, gates, states)
        args = (cu(q, dt), cu(k, dt), cu(v, dt), cu(i), cu(f), NH, cu(c0), cu(n0))
        before = chunkwise_v2.LAUNCHES
        h, (c, n) = chunkwise_v2.mlstm_siging_chunkwise_fw(*args, eps=EPS, return_last_states=True)
        torch.cuda.synchronize()
        assert chunkwise_v2.LAUNCHES == before + 1
        hp, (cp, np_) = chunkwise_v2.mlstm_siging_chunkwise_fw_plain(
            *args, eps=EPS, return_last_states=True)
        assert torch.isfinite(h.float()).all()
        torch.testing.assert_close(h.float(), hp.float(), **tol)
        torch.testing.assert_close(c, cp, **TOL)
        torch.testing.assert_close(n, np_, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,NH,DH", [(200, 12, 32), (300, 8, 64), (1000, 6, 128)])
def test_fused_outnorm_kernel_matches_plain_on_gpu(S, NH, DH, dtype):
    """The inference forward with the per-head LayerNorm fused in against
    its plain version, non-zero weight and bias, initial states, and v
    offset by 20 so that the rows of h have |mean| >> std (the centred
    variance).  Each output within 1e-4 (float32) or 2e-2 (bfloat16) of
    its largest |value|."""
    needs_cuda()
    dt = getattr(torch, dtype)
    q, k, v, i, f, c0, n0 = make_inputs(S + DH, 2, S, NH, DH, "open", True)
    rng = np.random.default_rng(DH)
    lnw, lnb = cu(1.0 + rng.normal(0, 0.3, NH * DH)), cu(rng.normal(0, 0.1, NH * DH))
    args = (cu(q, dt), cu(k, dt), cu(v + 20.0, dt), cu(i), cu(f), NH, lnw, lnb, cu(c0), cu(n0))
    before = (chunkwise_v2.LAUNCHES_LN, chunkwise_v2.LAUNCHES)
    h, (c, n) = chunkwise_v2.mlstm_siging_chunkwise_fw_ln(*args, eps=EPS,
                                                          return_last_states=True)
    torch.cuda.synchronize()
    assert (chunkwise_v2.LAUNCHES_LN, chunkwise_v2.LAUNCHES) == (before[0] + 1, before[1])
    hp, (cp, np_) = chunkwise_v2.mlstm_siging_chunkwise_fw_ln_plain(
        *args, eps=EPS, return_last_states=True)
    assert h.dtype == dt
    assert_rel_close([h], [hp], 1e-4 if dt == torch.float32 else 2e-2)
    assert_rel_close([c, n], [cp, np_], 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_forward_kernel_matches_plain_on_gpu(dtype):
    needs_cuda()
    dt = getattr(torch, dtype)
    tol = TOL if dt == torch.float32 else BF16_TOL
    for S, NH, DH, gates, states in CASES:
        q, k, v, i, f, c0, n0 = make_inputs(S + 1, 2, S, NH, DH, gates, states)
        args = (cu(q, dt), cu(k, dt), cu(v, dt), cu(i), cu(f), NH, cu(c0), cu(n0))
        before = chunkwise_v2.LAUNCHES_TRAIN
        h, (c, n), (cs, ns, den) = chunkwise_v2.mlstm_siging_chunkwise_fw_train(*args, eps=EPS)
        torch.cuda.synchronize()
        assert chunkwise_v2.LAUNCHES_TRAIN == before + 1
        hp, (cp, np_), (csp, nsp, denp) = chunkwise_v2.mlstm_siging_chunkwise_fw_train_plain(
            *args, eps=EPS)
        torch.testing.assert_close(h.float(), hp.float(), **tol)
        for a, b in ((c, cp), (n, np_), (cs, csp), (ns, nsp), (den, denp)):
            torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_on_gpu(dtype):
    """The same saved states and denominator go to both versions."""
    needs_cuda()
    dt = getattr(torch, dtype)
    for S, NH, DH, gates, states in CASES:
        q, k, v, i, f, c0, n0 = make_inputs(S + 2, 2, S, NH, DH, gates, states)
        rng = np.random.default_rng(S)
        dh = cu(rng.normal(size=q.shape), dt)
        dc_last = cu(rng.normal(size=(2, NH, DH, DH))) if states else None
        args = (cu(q, dt), cu(k, dt), cu(v, dt), cu(i), cu(f), NH)
        _, _, (cs, _, den) = chunkwise_v2.mlstm_siging_chunkwise_fw_train(
            *args, cu(c0), cu(n0), eps=EPS)
        before = chunkwise_v2.LAUNCHES_BW
        got = chunkwise_v2.mlstm_siging_chunkwise_bw(*args, cs, den, dh, dc_last, eps=EPS)
        torch.cuda.synchronize()
        assert chunkwise_v2.LAUNCHES_BW == before + 1
        ref = chunkwise_v2.mlstm_siging_chunkwise_bw_plain(*args, cs, den, dh, dc_last, eps=EPS)
        assert_grads_close(got[:3], ref[:3], dt)
        assert_grads_close(got[3:], ref[3:], torch.float32 if dt == torch.float32 else dt)


@pytest.mark.cuda
def test_cell_function_matches_plain_on_gpu():
    """The autograd Function on the card (both kernels, gate gradients in
    PyTorch) against the same Function on the CPU (plain versions)."""
    needs_cuda()
    S, NH, DH = 300, 4, 32
    q, k, v, i, f, c0, n0 = make_inputs(7, 2, S, NH, DH, "open", True)
    w = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        t = [torch.from_numpy(a).to(dev).requires_grad_(j != 6)
             for j, a in enumerate((q, k, v, i, f, c0, n0))]
        h = chunkwise_v2.mlstm_siging_chunkwise_train(*t[:5], NH, t[5], t[6], eps=EPS)
        loss = (h * torch.from_numpy(w).to(dev)).sum()
        out[dev] = [g.cpu() for g in torch.autograd.grad(loss, t[:6])]
    assert_grads_close(out["cuda"], out["cpu"], torch.float32)


def row_inputs(B, S, H, D, U, NH, offset, seed):
    rng = np.random.default_rng(seed)
    return dict(
        h=rng.normal(offset, 1.0, (B, S, H)), x=rng.normal(size=(B, S, H)),
        g_epi=rng.normal(size=(B, S, D)), ln_w=rng.normal(0, 0.1, H), ln_b=rng.normal(0, 0.1, H),
        skip=rng.normal(1, 0.1, H), wd_epi=rng.normal(0, H ** -0.5, (D, H)),
        xf=rng.normal(offset, 1.0, (B, S, D)), g_ffn=rng.normal(size=(B, S, D)),
        wn=rng.normal(1, 0.1, D), wgz=rng.normal(0, D ** -0.5, (2 * U, D)),
        bgz=rng.normal(0, 0.1, 2 * U), wd_ffn=rng.normal(0, U ** -0.5, (D, U)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,D,U,NH,offset", ROW_CASES)
def test_epilogue_backward_kernel_matches_plain_on_gpu(B, S, H, D, U, NH, offset, dtype):
    needs_cuda()
    dt = getattr(torch, dtype)
    a = row_inputs(B, S, H, D, U, NH, offset, seed=S)
    args = (cu(a["h"], dt), cu(a["x"], dt), cu(a["g_epi"], dt), cu(a["ln_w"]), cu(a["ln_b"]),
            cu(a["skip"]), cu(a["wd_epi"]), NH)
    before = epilogue.LAUNCHES
    got = epilogue.epilogue_bwd(*args)
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES == before + 1
    ref = epilogue.epilogue_bwd_plain(*args)
    assert_grads_close(got, ref, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,D,U,NH,offset", ROW_CASES)
def test_ffn_backward_kernel_matches_plain_on_gpu(B, S, H, D, U, NH, offset, dtype):
    needs_cuda()
    dt = getattr(torch, dtype)
    a = row_inputs(B, S, H, D, U, NH, offset, seed=S + 1)
    x, wn, wgz, wd = cu(a["xf"], dt), cu(a["wn"]), cu(a["wgz"]), cu(a["wd_ffn"])
    _, gz = ffn.ffn_forward(x, wn, wgz, cu(a["bgz"]), wd, torch.zeros(D, device="cuda"))
    g = cu(a["g_ffn"], dt)
    before = ffn.LAUNCHES
    got = ffn.ffn_bwd(x, gz, g, wn, wgz, wd)
    torch.cuda.synchronize()
    assert ffn.LAUNCHES == before + 1
    ref = ffn.ffn_bwd_plain(x, gz, g, wn, wgz, wd)
    assert_grads_close(got, ref, dt)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """CPU tensors go to the plain versions; a tensor on another device
    is refused (the wrappers never fall back)."""
    q, k, v, i, f, _, _ = make_inputs(0, 1, 30, 2, 16, "open", False)
    t = [torch.from_numpy(a) for a in (q, k, v, i, f)]
    before = chunkwise_v2.LAUNCHES_TRAIN
    chunkwise_v2.mlstm_siging_chunkwise_fw_train(*t, 2)
    assert chunkwise_v2.LAUNCHES_TRAIN == before
    meta = [a.to("meta") for a in t]
    with pytest.raises(ValueError, match="unsupported device"):
        chunkwise_v2.mlstm_siging_chunkwise_fw_train(*meta, 2)
    a = {k: torch.from_numpy(np.asarray(v, np.float32)).to("meta")
         for k, v in row_inputs(1, 30, 64, 32, 96, 4, 0.0, seed=0).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        epilogue.epilogue_bwd(a["h"], a["x"], a["g_epi"], a["ln_w"], a["ln_b"], a["skip"],
                              a["wd_epi"], 4)
    with pytest.raises(ValueError, match="unsupported device"):
        ffn.ffn_bwd(a["xf"], torch.empty(1, 30, 192, device="meta"), a["g_ffn"], a["wn"],
                    a["wgz"], a["wd_ffn"])


V1_CASES = [  # (L, chunks, NH, DH, gates, initial states and dC_last)
    (16, 3, 3, 16, "open", True),
    (32, 2, 2, 32, "closed", False),
    (64, 2, 4, 16, "open", False),
    (128, 2, 2, 32, "open", True),
    (256, 2, 2, 16, "closed", True),
    (512, 2, 2, 32, "open", False),
    (64, 2, 2, 64, "open", True),
    (32, 2, 1, 128, "closed", False),
    (512, 2, 1, 128, "open", True),   # 32-row dq/dk/dv tiles at DH 128
]
V1_TYPES = [("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16")]


def v1_inputs(seed, L, chunks, NH, DH, gates, states, dt):
    """(B, NH, S, DH) streams, (B, NH, S) gates, states, dh and dC_last."""
    rng = np.random.default_rng(seed)
    S = L * chunks
    q, k, v, dh = (cu(rng.normal(size=(2, NH, S, DH)), dt) for _ in range(4))
    i = cu(rng.normal(0, 1, (2, NH, S)))
    f = cu(rng.normal(2, 1, (2, NH, S)) if gates == "open" else rng.uniform(-60, -20, (2, NH, S)))
    c0, n0, dcl = (cu(rng.normal(size=s)) if states else None
                   for s in ((2, NH, DH, DH), (2, NH, DH), (2, NH, DH, DH)))
    return (q, k, v, i, f, c0, n0), dh, dcl


def assert_rel_close(got, ref, rel):
    for a, b in zip(got, ref):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=rel * max(b.abs().max().item(), 1e-30), rtol=rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,compute", V1_TYPES)
def test_v1_kernels_match_plain_on_gpu(dtype, compute):
    """The forward, the dC scan and dq/dk/dv each against its plain version
    on the same inputs (the backward kernels on the plain forward's saved
    states)."""
    needs_cuda()
    dt, cd = getattr(torch, dtype), getattr(torch, compute)
    rel = 1e-4 if cd == torch.float32 else 2e-2
    for L, chunks, NH, DH, gates, states in V1_CASES:
        args, dh, dcl = v1_inputs(L + DH, L, chunks, NH, DH, gates, states, dt)
        kw = dict(chunk_size=L, eps=EPS, compute_dtype=cd)
        before = (v1.LAUNCHES_FW, v1.LAUNCHES_BW_DC, v1.LAUNCHES_BW_DQKV)
        got = v1.chunkwise_fw(*args, **kw)
        torch.cuda.synchronize()
        ref = v1.chunkwise_fw_plain(*args, **kw)
        assert_rel_close(got, ref, rel)
        q, k, v, i, f = args[:5]
        _, den, cs = ref[:3]
        dcs, dc0 = v1.chunkwise_bw_dc(q, f, dh, den, dcl, **kw)
        torch.cuda.synchronize()
        rdcs, rdc0 = v1.chunkwise_bw_dc_plain(q, f, dh, den, dcl, **kw)
        assert_rel_close((dcs, dc0), (rdcs, rdc0), rel)
        got = v1.chunkwise_bw_dqkv(q, k, v, i, f, cs, den, dh, rdcs, **kw)
        torch.cuda.synchronize()
        assert_rel_close(got, v1.chunkwise_bw_dqkv_plain(q, k, v, i, f, cs, den, dh, rdcs, **kw),
                         rel)
        assert (v1.LAUNCHES_FW, v1.LAUNCHES_BW_DC, v1.LAUNCHES_BW_DQKV) == tuple(
            n + 1 for n in before)


@pytest.mark.cuda
def test_v1_function_matches_plain_on_gpu():
    """The v1 autograd Function on the card (three kernels, gate gradients
    in PyTorch) against the same Function on the CPU (plain versions),
    compute float32."""
    needs_cuda()
    args, dh, _ = v1_inputs(9, 64, 3, 4, 32, "open", True, torch.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        t = [a.to(dev).requires_grad_(j != 6) for j, a in enumerate(args)]
        h = v1.mlstm_siging_chunkwise_v1(*t[:5], chunk_size=64, c_initial=t[5], n_initial=t[6],
                                         eps=EPS, compute_dtype=torch.float32)
        out[dev] = [g.cpu() for g in torch.autograd.grad((h * dh.to(dev)).sum(), t[:6])]
    assert_grads_close(out["cuda"], out["cpu"], torch.float32)


EXP_CASES = [  # (L, chunks, NH, DH, gates, initial (C, n, m) and dC_last)
    (16, 3, 3, 16, "large_i", True),
    (32, 2, 2, 32, "closed", False),
    (64, 2, 4, 16, "open", False),
    (128, 2, 2, 32, "large_i", True),
    (256, 2, 2, 16, "closed", True),
    (512, 2, 2, 32, "large_i", False),
    (64, 2, 2, 64, "large_i", True),
    (16, 3, 1, 128, "closed", False),
    (512, 2, 1, 128, "large_i", True),
]


def exp_inputs(seed, L, chunks, NH, DH, gates, states, dt, qk_mean=0.0):
    """(B, NH, S, DH) streams (q, k ~ N(qk_mean, 1)), (B, NH, S) gates
    (open: i ~ N(0, 1), f ~ N(2, 1); large_i: i ~ U(5, 15); closed: f ~
    U(-60, -20)), (C, n, m), dh and dC_last."""
    rng = np.random.default_rng(seed)
    S = L * chunks
    q, k, v, dh = (cu(rng.normal(size=(2, NH, S, DH)) + (qk_mean if j < 2 else 0.0), dt)
                   for j in range(4))
    i = cu(rng.uniform(5, 15, (2, NH, S)) if gates == "large_i" else rng.normal(0, 1, (2, NH, S)))
    f = cu(rng.uniform(-60, -20, (2, NH, S)) if gates == "closed" else rng.normal(2, 1, (2, NH, S)))
    c0, n0, dcl = (cu(rng.normal(size=s)) if states else None
                   for s in ((2, NH, DH, DH), (2, NH, DH), (2, NH, DH, DH)))
    m0 = cu(rng.normal(0, 3, (2, NH))) if states else None
    return (q, k, v, i, f, c0, n0, m0), dh, dcl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,compute", V1_TYPES)
def test_exp_kernels_match_plain_on_gpu(dtype, compute):
    """The exp forward (both variants), the dC scan and dq/dk/dv each against
    its plain version on the same inputs (the backward kernels on the plain
    forward's saved rows)."""
    needs_cuda()
    dt, cd = getattr(torch, dtype), getattr(torch, compute)
    rel = 1e-4 if cd == torch.float32 else 2e-2
    for L, chunks, NH, DH, gates, states in EXP_CASES:
        args, dh, dcl = exp_inputs(L + DH + 7, L, chunks, NH, DH, gates, states, dt)
        kw = dict(chunk_size=L, eps=EPS, compute_dtype=cd)
        before = (exp.LAUNCHES_FW, exp.LAUNCHES_BW_DC, exp.LAUNCHES_BW_DQKV)
        got = exp.chunkwise_exp_fw(*args, **kw)
        torch.cuda.synchronize()
        ref = exp.chunkwise_exp_fw_plain(*args, **kw)
        num = lambda out: out[0].float() * (out[1] + EPS)[..., None]  # noqa: E731
        assert_rel_close([num(got), *got[1:5], *got[5]], [num(ref), *ref[1:5], *ref[5]], rel)
        got_p = exp.chunkwise_exp_fw(*args, save_states=False, **kw)
        assert got_p[1:5] == (None,) * 4
        assert torch.equal(got_p[0], got[0])  # the same arithmetic, fewer stores
        assert all(torch.equal(a, b) for a, b in zip(got_p[5], got[5]))
        q, k, v, i, f = args[:5]
        _, den, mc, cs, ms, (_, _, m_last) = ref
        mrow_dc, mrow_qkv = exp.m_rows(f, ms, m_last, L)
        dcs, dc0 = exp.chunkwise_exp_bw_dc(q, f, dh, den, mc, mrow_dc, dcl, **kw)
        torch.cuda.synchronize()
        rdcs, rdc0 = exp.chunkwise_exp_bw_dc_plain(q, f, dh, den, mc, mrow_dc, dcl, **kw)
        assert_rel_close((dcs, dc0), (rdcs, rdc0), rel)
        got = exp.chunkwise_exp_bw_dqkv(q, k, v, i, f, cs, den, mc, mrow_qkv, dh, rdcs, **kw)
        torch.cuda.synchronize()
        assert all(g.dtype == dt for g in got)
        assert_rel_close(got, exp.chunkwise_exp_bw_dqkv_plain(q, k, v, i, f, cs, den, mc,
                                                              mrow_qkv, dh, rdcs, **kw), rel)
        assert (exp.LAUNCHES_FW, exp.LAUNCHES_BW_DC, exp.LAUNCHES_BW_DQKV) == (
            before[0] + 2, before[1] + 1, before[2] + 1)


@pytest.mark.cuda
def test_exp_function_matches_plain_on_gpu():
    """The exp autograd Function on the card (three kernels, gate gradients
    in PyTorch) against the same Function on the CPU (plain versions),
    compute float32, large input gates and initial (C, n, m).  q and k share
    a positive mean and n_initial is positive, so no denominator cancels
    (each device computes its own)."""
    needs_cuda()
    args, dh, _ = exp_inputs(10, 64, 3, 4, 32, "large_i", True, torch.float32, qk_mean=1.0)
    args = (*args[:6], args[6].abs(), args[7])
    out = {}
    for dev in ("cpu", "cuda"):
        t = [a.to(dev).requires_grad_(j < 6) for j, a in enumerate(args)]
        h = exp.mlstm_chunkwise_exp(*t[:5], chunk_size=64, c_initial=t[5], n_initial=t[6],
                                    m_initial=t[7], eps=EPS, compute_dtype=torch.float32)
        out[dev] = [g.cpu() for g in torch.autograd.grad((h * dh.to(dev)).sum(), t[:6])]
    assert_grads_close(out["cuda"], out["cpu"], torch.float32)


PAR_CASES = [  # (S, NH, DH, gates): one tile, ragged tiles, several tiles
    (64, 3, 16, "open"),
    (200, 2, 32, "closed"),
    (448, 2, 32, "open"),
    (200, 2, 64, "open"),
    (448, 1, 128, "closed"),
]


def par_inputs(seed, S, NH, DH, gates, dt):
    """(B, NH, S, DH) streams and dh, (B, NH, S) gates (open: i ~ N(0, 1),
    f ~ N(3, 1); closed: f ~ U(-60, -20))."""
    rng = np.random.default_rng(seed)
    q, k, v, dh = (cu(rng.normal(size=(2, NH, S, DH)), dt) for _ in range(4))
    i = cu(rng.normal(0, 1, (2, NH, S)))
    f = cu(rng.normal(3, 1, (2, NH, S)) if gates == "open" else rng.uniform(-60, -20, (2, NH, S)))
    return (q, k, v, i, f), dh


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,compute", V1_TYPES)
def test_parallel_kernels_match_plain_on_gpu(dtype, compute):
    """The quadratic forward, dq and dk/dv kernels each against its plain
    version on the same inputs (the backward kernels on the plain forward's
    den), each output in the storage type."""
    needs_cuda()
    dt, cd = getattr(torch, dtype), getattr(torch, compute)
    rel = 1e-4 if cd == torch.float32 else 2e-2
    for S, NH, DH, gates in PAR_CASES:
        args, dh = par_inputs(S + DH, S, NH, DH, gates, dt)
        kw = dict(eps=EPS, compute_dtype=cd)
        before = (par.LAUNCHES_FW, par.LAUNCHES_BW_DQ, par.LAUNCHES_BW_DKV)
        got = par.parallel_fw(*args, **kw)
        torch.cuda.synchronize()
        ref = par.parallel_fw_plain(*args, **kw)
        assert got[0].dtype == dt
        assert_rel_close(got, ref, rel)
        den = ref[1]
        dq = par.parallel_bw_dq(*args, den, dh, **kw)
        dkv = par.parallel_bw_dkv(*args, den, dh, **kw)
        torch.cuda.synchronize()
        assert all(g.dtype == dt for g in (dq, *dkv))
        assert_rel_close([dq], [par.parallel_bw_dq_plain(*args, den, dh, **kw)], rel)
        assert_rel_close(dkv, par.parallel_bw_dkv_plain(*args, den, dh, **kw), rel)
        assert (par.LAUNCHES_FW, par.LAUNCHES_BW_DQ, par.LAUNCHES_BW_DKV) == tuple(
            n + 1 for n in before)


@pytest.mark.cuda
def test_parallel_function_matches_plain_on_gpu():
    """The quadratic autograd Function on the card (three kernels, gate
    gradients in PyTorch) against the same Function on the CPU (plain
    versions), compute float32."""
    needs_cuda()
    args, dh = par_inputs(11, 300, 4, 32, "open", torch.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        t = [a.to(dev).requires_grad_() for a in args]
        h = par.mlstm_siging_parallel_kernel(*t, eps=EPS, compute_dtype=torch.float32)
        out[dev] = [g.cpu() for g in torch.autograd.grad((h * dh.to(dev)).sum(), t)]
    assert_grads_close(out["cuda"], out["cpu"], torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_kernel_matches_plain_on_gpu(dtype):
    """The step kernel against ``mlstm_siging_step`` at the flagship's heads
    (B 8, NH 12, DH 32), at DH 16 and at the larger detectors' (NH 8, DH
    64; NH 6, DH 128), open and closed forget gates: h in the storage type,
    (C', n') float32."""
    needs_cuda()
    dt = getattr(torch, dtype)
    for NH, DH, gates in ((12, 32, "open"), (12, 32, "closed"), (3, 16, "open"),
                          (8, 64, "open"), (6, 128, "open"), (6, 128, "closed")):
        rng = np.random.default_rng(NH + DH)
        q, k, v = (cu(rng.normal(size=(8, NH, DH)), dt) for _ in range(3))
        i = cu(rng.normal(0, 2, (8, NH)))
        f = cu(rng.normal(2, 1, (8, NH)) if gates == "open" else rng.uniform(-60, -20, (8, NH)))
        c, n = cu(rng.normal(size=(8, NH, DH, DH))), cu(rng.normal(size=(8, NH, DH)))
        before = step.LAUNCHES
        h, (c1, n1) = step.mlstm_siging_step_kernel(q, k, v, i, f, c, n, eps=EPS)
        torch.cuda.synchronize()
        assert step.LAUNCHES == before + 1 and h.dtype == dt
        hp, (cp, np_) = mlstm_siging_step(q, k, v, i, f, c, n, eps=EPS)
        assert_rel_close([h], [hp], 1e-4 if dt == torch.float32 else 2e-2)
        assert_rel_close([c1, n1], [cp, np_], 1e-4)
