"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the chunkwise mLSTM inference forward (also with the per-head LayerNorm
fused in), train forward and backward (each of their two passes alone
too, q and k row-strided views; and the differentiable cell built from
them), the epilogue
backward, the FFN backward (at every detector's widths), the v1 and exp
routes' forward, dC scan and dq/dk/dv kernels
at every chunk length, the quadratic forward, dq and dk/dv kernels, and the
one-token step (also from the inference wrapper's token views, and on a
side stream), at head dims 16 and 32 (the flagship, vil-det-tiny), 64
(vil-det-256) and 128 (vil-det-384), and the row kernels at all their
widths; the fused TAL metric stage, the sLSTM scan (head dims 8 to 256,
ragged batch groups, S 0 and 2048, and its launch plan), and the sub-chunked
forward fw3 (both variants, and its states fed to the v2 backward); and the
validation path: device and CPU letterboxed val pixels byte-equal,
``vil-det-tiny``'s self-labelled val on the card, and a ``.pt`` checkpoint
of ``vil-det-192`` loaded back; the v2 kernels at the lengths of other
input sizes (S 9216, and 144 with a ragged chunk) and ``utils/resize.py``
on the card against its CPU result.  This
file imports neither JAX nor the JAX package, so it
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
- the v2 forward with bfloat16 products rounds the operands of its four
  products as JAX's ``_fw_body`` does, so its C states (and h) are held
  against the composition of its two plain passes
  (``mlstm_siging_chunkwise_fw_states_plain`` / ``_fw_out_plain``), each
  output within 2e-2 of its largest |value| (a float32 sum in another order
  can flip an operand's rounding by one bfloat16 step), and in mean error
  nearer them than the same passes without the rounding are
  (assert_rounding_shows); n, den and the float32 path as before.  The
  epilogue backward likewise against ``epilogue_bwd_rounded_plain``, mean
  error within 1e-4 of the mean |value| in bfloat16;
- the v1 and exp kernels round the operands of their products to the
  compute type at the same points as their plain versions: each output
  within 1e-4 of its largest |value| with compute float32, 2e-2 with compute
  bfloat16 (a float32 sum in another order can flip the rounding of an
  operand by one bfloat16 step).  The TAL metric stage: align, overlaps
  and mask_pos equal bit for bit (both sides round every operation once,
  in the same order; a NaN metric, which no selection takes, where the
  plain version's row max takes none of its row).  The sLSTM scan (float32): each output within 1e-5
  of its largest |value| (its recurrent sums in another order) or, where
  float32 rounding compounds over 2048 steps beyond that, at most twice as
  far from the plain scan in float64 as the float32 plain scan is, as
  chip_smoke.py's phase_slstm_kernel holds it.  The exp
  forward's h is held as its
  numerator h (den + eps) beside den: the floor e^{-m_comb} of its
  denominator is tiny once m is large, so a row whose terms nearly cancel
  turns a float32 rounding of den into a large relative change of h.
"""

import numpy as np
import pytest
import torch

from xlstm_yolo_tpu_torch.ops import chunkwise as v1
from xlstm_yolo_tpu_torch.ops import chunkwise_exp as exp
from xlstm_yolo_tpu_torch.ops import chunkwise_fw3, chunkwise_v2, epilogue, ffn, step
from xlstm_yolo_tpu_torch.ops import parallel as par
from xlstm_yolo_tpu_torch.ops import slstm, tal_metric
from xlstm_yolo_tpu_torch.ops.mlstm_recurrent import mlstm_siging_step

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# the bfloat16 v2 forward against its plain passes: C (float32 sums of the
# same rounded operands in another order) within BF16_STATE_REL of its
# largest |value|; the fused LayerNorm's h of |mean| >> std rows against
# the passes with float64 sums, at most LN_BF16_MAX of its largest |value|
# and LN_BF16_MEAN in mean |error| over mean |value| (the normalisation
# magnifies each operand whose rounding a float32 sum flips).  The limits
# are chip_smoke.py's, set from its readings on the H100: one flipped
# k e^a times v moves its element of C by ~2e-3 of C's largest |value|
BF16_STATE_REL = 5e-3
LN_BF16_MAX, LN_BF16_MEAN = 0.1, 1e-4
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
        torch.testing.assert_close(n, np_, **TOL)
        if dt == torch.float32:
            torch.testing.assert_close(c, cp, **TOL)
        else:  # C sums R(k e^a)^T R(v), as JAX's bfloat16 forward does
            sh, _, _, _, sc, _ = ref = fw_split_plain(args)
            assert_rel_close([h], [sh], 2e-2)
            assert_rel_close([c], [sc], BF16_STATE_REL)
            unr = fw_split_plain(unrounded(args))
            assert_rounding_shows([h, c], [sh, sc], [unr[0], unr[4]])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,NH,DH", [(200, 12, 32), (300, 8, 64), (1000, 6, 128)])
def test_fused_outnorm_kernel_matches_plain_on_gpu(S, NH, DH, dtype):
    """The inference forward with the per-head LayerNorm fused in against
    its plain version, non-zero weight and bias, initial states, and v
    offset by 20 so that the rows of h have |mean| >> std (the centred
    variance).  Each output within 1e-4 of its largest |value| in float32.
    In bfloat16 the products round their operands as JAX's forward does,
    and the LayerNorm of such rows magnifies a rounding that a float32 sum
    in another order flips: h is held against the two plain passes with
    float64 sums, which round where the kernel does, at most LN_BF16_MAX
    of its largest |value| and LN_BF16_MEAN in mean error, and nearer them
    in mean error than the unrounded version is; C against the passes
    within BF16_STATE_REL, n within 1e-4; without the offset h within 2e-2
    of the passes."""
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
    if dt == torch.float32:
        assert_rel_close([h, c, n], [hp, cp, np_], 1e-4)
    else:
        split_args = (*args[:6], *args[8:])
        sh, _, _, _, sc, sn = fw_split_plain(split_args, (lnw, lnb), torch.float64)
        assert_ln_h_close(h, sh, chunkwise_v2.mlstm_siging_chunkwise_fw_ln_plain(
            *(a.double() if isinstance(a, torch.Tensor) else a for a in args), eps=EPS))
        assert_rel_close([c], [sc], BF16_STATE_REL)
        assert_rel_close([n, n], [sn, np_], 1e-4)
        args = (*args[:2], cu(v, dt), *args[3:])  # no offset: rows of mean ~ 0
        h = chunkwise_v2.mlstm_siging_chunkwise_fw_ln(*args, eps=EPS)
        assert_rel_close([h], [fw_split_plain(split_args[:2] + args[2:3] + split_args[3:],
                                              (lnw, lnb))[0]], 2e-2)


def assert_ln_h_close(h, ref, ref_unrounded):
    """The fused LayerNorm's bfloat16 h against the passes with float64
    sums (``ref``): at most LN_BF16_MAX of its largest |value|, LN_BF16_MEAN
    in mean |error| over mean |value|, and under half the unrounded
    version's mean distance from ``ref``."""
    a, b = h.double(), ref.double()
    assert torch.isfinite(a).all()
    assert (a - b).abs().max().item() <= LN_BF16_MAX * b.abs().max().item()
    assert (a - b).abs().mean().item() <= LN_BF16_MEAN * b.abs().mean().item()
    assert_rounding_shows([h], [ref], [ref_unrounded])


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
        for a, b in ((n, np_), (ns, nsp), (den, denp)):
            torch.testing.assert_close(a, b, **TOL)
        if dt == torch.float32:
            torch.testing.assert_close(c, cp, **TOL)
            torch.testing.assert_close(cs, csp, **TOL)
        else:  # C sums R(k e^a)^T R(v), as JAX's bfloat16 forward does
            sh, _, scs, _, sc, _ = fw_split_plain(args)
            assert_rel_close([h], [sh], 2e-2)
            assert_rel_close([c, cs], [sc, scs], BF16_STATE_REL)
            unr = fw_split_plain(unrounded(args))
            assert_rounding_shows([h, c, cs], [sh, sc, scs], [unr[0], unr[4], unr[2]])


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


def fw_split_plain(args, ln=(None, None), acc=None):
    """The forward's two plain passes composed (what the kernels compute,
    rounding included; sums in ``acc``, default float32): h, den,
    c_states, n_states, c_last, n_last."""
    q, k, v, i, f, NH, c0, n0 = args
    cs, ns, (cl, nl) = chunkwise_v2.mlstm_siging_chunkwise_fw_states_plain(k, v, i, f, NH, c0,
                                                                           n0, acc=acc)
    h, den = chunkwise_v2.mlstm_siging_chunkwise_fw_out_plain(q, k, v, i, f, NH, cs, ns, eps=EPS,
                                                              ln_weight=ln[0], ln_bias=ln[1],
                                                              acc=acc)
    return h, den, cs, ns, cl, nl


def unrounded(args):
    """The forward's arguments with q, k and v in float32: the plain
    passes on them skip the products' bfloat16 rounding."""
    return (*(a.float() for a in args[:3]), *args[3:])


def strided(q, k):
    """q and k as the cell hands them over: views of one (B, S, 2H)
    projection, rows 2H apart."""
    qk = torch.cat([q, k], -1)
    return qk.split(q.shape[-1], -1)


FW_PASS_CASES = [  # (S, NH, DH, gates, initial states): head dims 16-128, ragged S
    (25, 4, 16, "open", False),
    (100, 3, 16, "closed", True),
    (1000, 12, 32, "open", True),
    (200, 4, 32, "closed", False),
    (300, 8, 64, "closed", True),
    (130, 8, 64, "open", False),
    (200, 6, 128, "closed", True),
    (1000, 6, 128, "open", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,NH,DH,gates,states", FW_PASS_CASES)
def test_forward_passes_match_plain_on_gpu(S, NH, DH, gates, states, dtype):
    """The forward's two passes, each against its plain version on the same
    inputs (the second on the first's plain states), q and k row-strided
    views: the state scan with C kept in float32 (train) and in the storage
    type (inference), the output pass from float32 and from storage-type
    states and with the LayerNorm fused in.  float32 within 1e-4 of each
    output's largest |value|; bfloat16 h within 2e-2, C within
    BF16_STATE_REL, n and den within 1e-4, and in mean error nearer the
    plain passes than the same passes without the products' rounding are.
    Then each forward wrapper (one counted launch) against the
    composition."""
    needs_cuda()
    dt = getattr(torch, dtype)
    rel = 1e-4 if dt == torch.float32 else 2e-2
    c_rel = 1e-4 if dt == torch.float32 else BF16_STATE_REL
    q, k, v, i, f, c0, n0 = make_inputs(S + DH + 3, 2, S, NH, DH, gates, states)
    qv, kv = strided(cu(q, dt), cu(k, dt))
    args = (qv, kv, cu(v, dt), cu(i), cu(f), NH, cu(c0), cu(n0))
    rng = np.random.default_rng(DH)
    ln = (cu(1.0 + rng.normal(0, 0.3, NH * DH)), cu(rng.normal(0, 0.1, NH * DH)))
    ref = fw_split_plain(args)
    ref_ln = fw_split_plain(args, ln)[0]
    unr = fw_split_plain(unrounded(args)) if dt == torch.bfloat16 else None
    h_ref, den_ref, cs_ref, ns_ref, cl_ref, nl_ref = ref
    for save in (True, False):
        cs, ns, (cl, nl) = chunkwise_v2.mlstm_siging_chunkwise_fw_states(*args[1:],
                                                                         save_states=save)
        torch.cuda.synchronize()
        assert cs.dtype == (torch.float32 if save else dt)
        # the storage-type scratch holds C rounded once more
        assert_rel_close([cs], [cs_ref], c_rel if save else rel)
        assert_rel_close([cl, ns, nl], [cl_ref, ns_ref, nl_ref], c_rel)
        if unr is not None and save:
            assert_rounding_shows([cs, cl], [cs_ref, cl_ref], [unr[2], unr[4]])
    for c_states in (cs_ref, cs_ref.to(dt)):
        h, den = chunkwise_v2.mlstm_siging_chunkwise_fw_out(*args[:6], c_states, ns_ref, eps=EPS)
        torch.cuda.synchronize()
        assert_rel_close([h], [h_ref], rel)
        assert_rel_close([den], [den_ref], 1e-4)
        if unr is not None:
            assert_rounding_shows([h], [h_ref], [unr[0]])
    h_ln, _ = chunkwise_v2.mlstm_siging_chunkwise_fw_out(*args[:6], cs_ref.to(dt), ns_ref,
                                                         eps=EPS, ln_weight=ln[0], ln_bias=ln[1])
    assert_rel_close([h_ln], [ref_ln], rel)
    before = (chunkwise_v2.LAUNCHES, chunkwise_v2.LAUNCHES_TRAIN, chunkwise_v2.LAUNCHES_LN)
    h, (cl, nl) = chunkwise_v2.mlstm_siging_chunkwise_fw(*args, eps=EPS, return_last_states=True)
    ht, _, (cs, ns, den) = chunkwise_v2.mlstm_siging_chunkwise_fw_train(*args, eps=EPS)
    hl = chunkwise_v2.mlstm_siging_chunkwise_fw_ln(*args[:6], *ln, *args[6:], eps=EPS)
    torch.cuda.synchronize()
    assert (chunkwise_v2.LAUNCHES, chunkwise_v2.LAUNCHES_TRAIN,
            chunkwise_v2.LAUNCHES_LN) == tuple(b + 1 for b in before)
    assert_rel_close([h, ht, hl], [h_ref, h_ref, ref_ln], rel)
    assert_rel_close([cl, nl, cs, ns], [cl_ref, nl_ref, cs_ref, ns_ref], c_rel)
    assert_rel_close([den], [den_ref], 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_forward_feeds_the_backward_on_gpu(dtype):
    """The differentiable cell on the card (the train forward's states and
    den feeding the v2 backward, q and k row-strided views as the model
    hands them over) against the plain cell on the same inputs: the
    gradients of q, k, v, i, f and C0 within 1e-4 (float32) or 2e-2
    (bfloat16) of their largest |value|.  In bfloat16 the plain cell, whose
    forward keeps the products in float32 and whose gate gradients come
    from dq and dk before their rounding, is the reference of q, k, v and
    C0 only; all six are held against the plain passes that round where
    the kernels do (fw_states/fw_out, bw_dc/bw_dqkv, gate_grads)."""
    needs_cuda()
    dt = getattr(torch, dtype)
    for S, NH, DH in ((300, 4, 32), (1000, 6, 128), (130, 8, 64)):
        q, k, v, i, f, c0, n0 = make_inputs(S + DH + 5, 2, S, NH, DH, "open", True)
        w = torch.from_numpy(np.random.default_rng(S).normal(size=q.shape).astype(np.float32))
        out = {}
        for dev in ("cpu", "cuda"):
            leaves = [torch.from_numpy(a).to(dev) for a in (q, k, v, i, f, c0)]
            leaves[:3] = [t.to(dt) for t in leaves[:3]]
            for t in leaves:
                t.requires_grad_()
            qv, kv = strided(leaves[0], leaves[1])
            n0_ = torch.from_numpy(n0).to(dev)
            fn = (chunkwise_v2.mlstm_siging_chunkwise_train if dev == "cuda"
                  else chunkwise_v2.mlstm_siging_chunkwise_train_plain)
            before = chunkwise_v2.LAUNCHES_TRAIN, chunkwise_v2.LAUNCHES_BW
            h = fn(qv, kv, *leaves[2:5], NH, leaves[5], n0_, eps=EPS)
            loss = (h.float() * w.to(dev)).sum()
            out[dev] = [g.float().cpu() for g in torch.autograd.grad(loss, leaves)]
            if dev == "cuda":
                torch.cuda.synchronize()
                assert (chunkwise_v2.LAUNCHES_TRAIN, chunkwise_v2.LAUNCHES_BW) == (
                    before[0] + 1, before[1] + 1)
        keep = range(6) if dt == torch.float32 else (0, 1, 2, 5)
        assert_grads_close([out["cuda"][j] for j in keep], [out["cpu"][j] for j in keep], dt)
        if dt == torch.bfloat16:
            assert_grads_close(out["cuda"], rounding_cell_grads(
                q, k, v, i, f, c0, n0, NH, w.to(dt)), dt)


def rounding_cell_grads(q, k, v, i, f, c0, n0, NH, dh):
    """The cell's gradients (dq, dk, dv, di, df, dC0) from the plain
    passes on the CPU, rounding where the kernels do: the forward's state
    scan and output pass, the backward's dC scan and dq/dk/dv, then the
    gate gradients from the rounded dq and dk, for the loss sum(h * dh)
    with q, k, v in dh's dtype."""
    dt = dh.dtype
    q, k, v = (torch.from_numpy(a).to(dt) for a in (q, k, v))
    i, f, c0, n0 = (torch.from_numpy(a) for a in (i, f, c0, n0))
    cs, ns, _ = chunkwise_v2.mlstm_siging_chunkwise_fw_states_plain(k, v, i, f, NH, c0, n0)
    _, den = chunkwise_v2.mlstm_siging_chunkwise_fw_out_plain(q, k, v, i, f, NH, cs, ns, eps=EPS)
    dcs, dc0 = chunkwise_v2.mlstm_siging_chunkwise_bw_dc_plain(q, f, NH, den, dh, eps=EPS)
    dq, dk, dv = chunkwise_v2.mlstm_siging_chunkwise_bw_dqkv_plain(q, k, v, i, f, NH, cs, den, dh,
                                                                   dcs, eps=EPS)
    di, df = chunkwise_v2.gate_grads(q, k, dq, dk, i, f, NH)
    return [g.float() for g in (dq, dk, dv, di, df, dc0)]


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
    rounded = epilogue.epilogue_bwd_rounded_plain(*args)
    assert_grads_close(got, rounded, dt)
    if dt == torch.bfloat16:  # the kernel rounds where its plain version does
        for a, b in zip(got, rounded):
            a, b = a.double(), b.double()
            assert (a - b).abs().mean().item() <= 1e-4 * b.abs().mean().item()


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


FFN_CASES = [  # (B, S, D, U, mean offset): every detector's (D, U), ragged rows
    (2, 100, 32, 128, 0.0),      # vil-det-tiny's widths
    (1, 1000, 192, 512, 50.0),   # the flagship's, |mean| >> std rows
    (2, 130, 256, 704, 0.0),     # vil-det-256's
    (1, 300, 384, 1024, 50.0),   # vil-det-384's, |mean| >> std rows
    (3, 37, 384, 1024, 0.0),     # less than one 64-row tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,D,U,offset", FFN_CASES)
def test_ffn_backward_kernel_at_every_width_on_gpu(B, S, D, U, offset, dtype):
    """The FFN backward (bfloat16: tensor cores; float32: CUDA cores) against
    its plain version at every detector's (D, U), one launch a call."""
    needs_cuda()
    dt = getattr(torch, dtype)
    a = row_inputs(B, S, 4 * D, D, U, 4, offset, seed=S + D)
    x, wn, wgz, wd = cu(a["xf"], dt), cu(a["wn"]), cu(a["wgz"]), cu(a["wd_ffn"])
    _, gz = ffn.ffn_forward(x, wn, wgz, cu(a["bgz"]), wd, torch.zeros(D, device="cuda"))
    g = cu(a["g_ffn"], dt)
    before = ffn.LAUNCHES
    got = ffn.ffn_bwd(x, gz, g, wn, wgz, wd)
    torch.cuda.synchronize()
    assert ffn.LAUNCHES == before + 1
    assert_grads_close(got, ffn.ffn_bwd_plain(x, gz, g, wn, wgz, wd), dt)


def test_ffn_backward_refuses_other_widths():
    """A width the kernel does not take raises before the device check."""
    x = torch.empty(1, 30, 48, device="meta")
    with pytest.raises(ValueError, match="not taken by the kernel"):
        ffn.ffn_bwd(x, torch.empty(1, 30, 256, device="meta"), x, torch.empty(48, device="meta"),
                    torch.empty(256, 48, device="meta"), torch.empty(48, 128, device="meta"))


BW_PASS_CASES = [  # (S, NH, DH, gates, dC_last): head dims 16-128, ragged S, closed gates
    (25, 4, 16, "open", False),
    (100, 3, 16, "closed", True),
    (1000, 12, 32, "open", True),
    (200, 4, 32, "closed", False),
    (300, 8, 64, "closed", True),
    (200, 6, 128, "closed", True),
    (1000, 6, 128, "open", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,NH,DH,gates,dc_last", BW_PASS_CASES)
def test_backward_passes_match_plain_on_gpu(S, NH, DH, gates, dc_last, dtype):
    """The backward's two passes, each against its plain version on the
    same inputs (the second on the first's plain output): float32 within
    1e-4 of each output's largest |value| (sums in another order);
    bfloat16 within 2e-2 (both round the products' operands at the same
    points, but a float32 sum in another order can flip an operand's
    rounding by one bfloat16 step).  Then the whole backward (one counted
    launch) against the two plain passes."""
    needs_cuda()
    dt = getattr(torch, dtype)
    rel = 1e-4 if dt == torch.float32 else 2e-2
    q, k, v, i, f, _, _ = make_inputs(S + DH, 2, S, NH, DH, gates, False)
    rng = np.random.default_rng(S + 1)
    dh = cu(rng.normal(size=q.shape), dt)
    dcl = cu(rng.normal(size=(2, NH, DH, DH))) if dc_last else None
    args = (cu(q, dt), cu(k, dt), cu(v, dt), cu(i), cu(f), NH)
    _, _, (cs, _, den) = chunkwise_v2.mlstm_siging_chunkwise_fw_train(*args, eps=EPS)
    dcs, dc0 = chunkwise_v2.mlstm_siging_chunkwise_bw_dc(args[0], args[4], NH, den, dh, dcl,
                                                         eps=EPS)
    torch.cuda.synchronize()
    rdcs, rdc0 = chunkwise_v2.mlstm_siging_chunkwise_bw_dc_plain(args[0], args[4], NH, den, dh,
                                                                 dcl, eps=EPS)
    assert dcs.dtype == rdcs.dtype == dt
    assert_rel_close([dcs, dc0], [rdcs, rdc0], rel)
    got = chunkwise_v2.mlstm_siging_chunkwise_bw_dqkv(*args, cs, den, dh, rdcs, eps=EPS)
    torch.cuda.synchronize()
    ref = chunkwise_v2.mlstm_siging_chunkwise_bw_dqkv_plain(*args, cs, den, dh, rdcs, eps=EPS)
    assert_rel_close(got, ref, rel)
    before = chunkwise_v2.LAUNCHES_BW
    whole = chunkwise_v2.mlstm_siging_chunkwise_bw(*args, cs, den, dh, dcl, eps=EPS)
    torch.cuda.synchronize()
    assert chunkwise_v2.LAUNCHES_BW == before + 1
    assert_rel_close(whole, [*ref, rdc0], rel)


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
    counts = (chunkwise_fw3.LAUNCHES_FW3, chunkwise_fw3.LAUNCHES_FW3_TRAIN)
    for save in (True, False):
        got = chunkwise_fw3.fw3(*t, 2, chunk_size=16, sub_chunk=8, save_states=save)
        ref = chunkwise_fw3.fw3_plain(*t, 2, chunk_size=16, sub_chunk=8, save_states=save)
        assert all(a is b is None or torch.equal(a, b) for a, b in zip(got, ref))
        with pytest.raises(ValueError, match="unsupported device"):
            chunkwise_fw3.fw3(*meta, 2, chunk_size=16, save_states=save)
    assert (chunkwise_fw3.LAUNCHES_FW3, chunkwise_fw3.LAUNCHES_FW3_TRAIN) == counts


V1_CASES = [  # (L, chunks, NH, DH, gates, initial states and dC_last)
    (16, 3, 3, 16, "open", True),
    (32, 2, 2, 32, "closed", False),
    (64, 2, 4, 16, "open", False),
    (128, 2, 2, 32, "open", True),
    (256, 2, 2, 16, "closed", True),
    (512, 2, 2, 32, "open", False),
    (64, 2, 2, 64, "open", True),
    (32, 2, 1, 128, "closed", False),
    (512, 2, 1, 128, "open", True),   # dk/dv in two 32-query steps a sub-tile at DH 128
    (256, 2, 2, 64, "open", True),    # four 64-row sub-tiles a chunk at DH 64
    (64, 3, 1, 128, "closed", False),  # one whole sub-tile a chunk at DH 128
    (512, 8, 1, 128, "open", True),    # the state pass's carry over eight chunks
    (64, 3, 2, 32, "small_i", True),   # h mostly R(qbar) R(C_prev): its rounding shows
    (64, 13, 2, 32, "open", True),     # dC carried over the plan's 13 chunks
    (64, 13, 1, 128, "closed", True),
]
V1_TYPES = [("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16")]
# The v1 and exp forwards' outputs the products reach by less than this of
# their mean |value| (C and den with small or closed gates, where every key
# is scaled to ~0) show no rounding (assert_rounding_shows): their bf16-vs-
# float32 gap falls to 1e-7 - 1e-15, at or below float32's resolution.
FW_MIN_GAP = 1e-5


def v1_inputs(seed, L, chunks, NH, DH, gates, states, dt):
    """(B, NH, S, DH) streams, (B, NH, S) gates (open: i ~ N(0, 1), f ~
    N(2, 1); closed: f ~ U(-60, -20); small_i: i ~ N(-12, 1), so that D is
    at most ~e^-9 and h mostly the inter-chunk product), states, dh and
    dC_last."""
    rng = np.random.default_rng(seed)
    S = L * chunks
    q, k, v, dh = (cu(rng.normal(size=(2, NH, S, DH)), dt) for _ in range(4))
    i = cu(rng.normal(-12 if gates == "small_i" else 0, 1, (2, NH, S)))
    f = cu(rng.uniform(-60, -20, (2, NH, S)) if gates == "closed" else rng.normal(2, 1, (2, NH, S)))
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
    states).  With bfloat16 products the forward's outputs, the dC scan's
    and dq, dk and dv also lie nearer the plain version in mean error than
    its float32-products twin does (assert_rounding_shows)."""
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
        if cd == torch.bfloat16:  # small_i's C, and den, barely see the products
            assert_rounding_shows(got, ref, v1.chunkwise_fw_plain(
                *args, **dict(kw, compute_dtype=torch.float32)), min_gap=FW_MIN_GAP)
        q, k, v, i, f = args[:5]
        _, den, cs = ref[:3]
        dcs, dc0 = v1.chunkwise_bw_dc(q, f, dh, den, dcl, **kw)
        torch.cuda.synchronize()
        rdcs, rdc0 = v1.chunkwise_bw_dc_plain(q, f, dh, den, dcl, **kw)
        assert_rel_close((dcs, dc0), (rdcs, rdc0), rel)
        if cd == torch.bfloat16:  # closed gates: the increments ~e^-20 of dC_last
            assert_rounding_shows((dcs, dc0), (rdcs, rdc0), v1.chunkwise_bw_dc_plain(
                q, f, dh, den, dcl, **dict(kw, compute_dtype=torch.float32)), min_gap=FW_MIN_GAP)
        got = v1.chunkwise_bw_dqkv(q, k, v, i, f, cs, den, dh, rdcs, **kw)
        torch.cuda.synchronize()
        ref = v1.chunkwise_bw_dqkv_plain(q, k, v, i, f, cs, den, dh, rdcs, **kw)
        assert_rel_close(got, ref, rel)
        if cd == torch.bfloat16:
            assert_rounding_shows(got, ref, v1.chunkwise_bw_dqkv_plain(
                q, k, v, i, f, cs, den, dh, rdcs, **dict(kw, compute_dtype=torch.float32)))
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
    (256, 2, 2, 64, "large_i", True),  # four 64-row sub-tiles a chunk at DH 64
    (64, 3, 1, 128, "open", False),    # one whole sub-tile a chunk at DH 128
    (512, 8, 1, 128, "large_i", True),  # the state pass's carry over eight chunks
    (64, 3, 2, 32, "small_i", True),    # h mostly R(qbar) R(C_prev) (scale not a power of 2)
    (64, 13, 2, 32, "large_i", True),   # dC carried over the plan's 13 chunks
    (64, 13, 1, 128, "closed", True),
]


def exp_inputs(seed, L, chunks, NH, DH, gates, states, dt, qk_mean=0.0):
    """(B, NH, S, DH) streams (q, k ~ N(qk_mean, 1)), (B, NH, S) gates
    (open: i ~ N(0, 1), f ~ N(2, 1); large_i: i ~ U(5, 15); small_i: i ~
    N(-12, 1); closed: f ~ U(-60, -20)), (C, n, m), dh and dC_last."""
    rng = np.random.default_rng(seed)
    S = L * chunks
    q, k, v, dh = (cu(rng.normal(size=(2, NH, S, DH)) + (qk_mean if j < 2 else 0.0), dt)
                   for j in range(4))
    i = cu(rng.uniform(5, 15, (2, NH, S)) if gates == "large_i"
           else rng.normal(-12 if gates == "small_i" else 0, 1, (2, NH, S)))
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
    forward's saved rows).  With bfloat16 products the forward's outputs
    (h as its numerator h (den + eps): with large input gates a row whose
    denominator cancels to its tiny floor e^{-m_comb} turns a float32
    rounding of den into a large change of h), the dC scan's and dq, dk and
    dv also lie nearer the plain version in mean error than its
    float32-products twin does (assert_rounding_shows)."""
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
        if cd == torch.bfloat16:  # h as its numerator, as above
            ref32 = exp.chunkwise_exp_fw_plain(*args, **dict(kw, compute_dtype=torch.float32))
            assert_rounding_shows([num(got), *got[1:4]], [num(ref), *ref[1:4]],
                                  [num(ref32), *ref32[1:4]], min_gap=FW_MIN_GAP)
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
        if cd == torch.bfloat16:
            assert_rounding_shows((dcs, dc0), (rdcs, rdc0), exp.chunkwise_exp_bw_dc_plain(
                q, f, dh, den, mc, mrow_dc, dcl, **dict(kw, compute_dtype=torch.float32)),
                min_gap=FW_MIN_GAP)
        got = exp.chunkwise_exp_bw_dqkv(q, k, v, i, f, cs, den, mc, mrow_qkv, dh, rdcs, **kw)
        torch.cuda.synchronize()
        assert all(g.dtype == dt for g in got)
        bw = (q, k, v, i, f, cs, den, mc, mrow_qkv, dh, rdcs)
        ref = exp.chunkwise_exp_bw_dqkv_plain(*bw, **kw)
        assert_rel_close(got, ref, rel)
        if cd == torch.bfloat16:
            assert_rounding_shows(got, ref, exp.chunkwise_exp_bw_dqkv_plain(
                *bw, **dict(kw, compute_dtype=torch.float32)))
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


DC_PLAN = [(6656, 512), (2048, 512), (512, 256), (128, 64)]  # the detectors' training (S, L)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["v1", "exp"])
@pytest.mark.parametrize("DH", [32, 64, 128])
def test_dc_scans_match_plain_on_gpu(route, DH):
    """The v1 and exp dC scans alone at every (S, L) of the detectors'
    training plan (up to 13 chunks), bfloat16 streams and products, with
    dC_last on every other shape: within 2e-2 of each output's largest
    |value|, nearer the plain version in mean error than its
    float32-products twin is (assert_rounding_shows), one launch a call."""
    needs_cuda()
    NH = 256 // DH // 2
    for j, (S, L) in enumerate(DC_PLAN):
        states = j % 2 == 0
        kw = dict(chunk_size=L, eps=EPS, compute_dtype=torch.bfloat16)
        kw32 = dict(kw, compute_dtype=torch.float32)
        if route == "v1":
            args, dh, dcl = v1_inputs(S + DH, L, S // L, NH, DH, "open", states, torch.bfloat16)
            q, f = args[0], args[4]
            den = v1.chunkwise_fw_plain(*args, **kw)[1]
            before = v1.LAUNCHES_BW_DC
            got = v1.chunkwise_bw_dc(q, f, dh, den, dcl, **kw)
            torch.cuda.synchronize()
            assert v1.LAUNCHES_BW_DC == before + 1
            ref = v1.chunkwise_bw_dc_plain(q, f, dh, den, dcl, **kw)
            ref32 = v1.chunkwise_bw_dc_plain(q, f, dh, den, dcl, **kw32)
        else:
            args, dh, dcl = exp_inputs(S + DH, L, S // L, NH, DH, "large_i", states,
                                       torch.bfloat16)
            q, f = args[0], args[4]
            _, den, mc, _, ms, (_, _, m_last) = exp.chunkwise_exp_fw_plain(*args, **kw)
            mrow = exp.m_rows(f, ms, m_last, L)[0]
            before = exp.LAUNCHES_BW_DC
            got = exp.chunkwise_exp_bw_dc(q, f, dh, den, mc, mrow, dcl, **kw)
            torch.cuda.synchronize()
            assert exp.LAUNCHES_BW_DC == before + 1
            ref = exp.chunkwise_exp_bw_dc_plain(q, f, dh, den, mc, mrow, dcl, **kw)
            ref32 = exp.chunkwise_exp_bw_dc_plain(q, f, dh, den, mc, mrow, dcl, **kw32)
        assert_rel_close(got, ref, 2e-2)
        assert_rounding_shows(got, ref, ref32)


PAR_CASES = [  # (S, NH, DH, gates): one tile, ragged tiles, several tiles
    (64, 3, 16, "open"),
    (200, 2, 32, "closed"),
    (448, 2, 32, "open"),
    (200, 2, 64, "open"),
    (448, 1, 128, "closed"),
    (200, 2, 128, "open"),   # ragged, DH 128: dK/dV's two 32-query steps per tile
    (130, 1, 16, "closed"),  # ragged last tile of two rows
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
    den), each output in the storage type.  With bfloat16 products the
    forward's, dq's and dk/dv's outputs also lie nearer the plain version in
    mean error than its float32-products twin does (assert_rounding_shows)."""
    needs_cuda()
    dt, cd = getattr(torch, dtype), getattr(torch, compute)
    rel = 1e-4 if cd == torch.float32 else 2e-2
    for S, NH, DH, gates in PAR_CASES:
        args, dh = par_inputs(S + DH, S, NH, DH, gates, dt)
        kw = dict(eps=EPS, compute_dtype=cd)
        kw32 = dict(eps=EPS, compute_dtype=torch.float32)
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
        dq_ref = par.parallel_bw_dq_plain(*args, den, dh, **kw)
        assert_rel_close([dq], [dq_ref], rel)
        dkv_ref = par.parallel_bw_dkv_plain(*args, den, dh, **kw)
        assert_rel_close(dkv, dkv_ref, rel)
        if cd == torch.bfloat16:
            assert_rounding_shows(got, ref, par.parallel_fw_plain(*args, **kw32))
            assert_rounding_shows([dq], [dq_ref], [par.parallel_bw_dq_plain(*args, den, dh,
                                                                            **kw32)])
            assert_rounding_shows(dkv, dkv_ref, par.parallel_bw_dkv_plain(*args, den, dh, **kw32))
        assert (par.LAUNCHES_FW, par.LAUNCHES_BW_DQ, par.LAUNCHES_BW_DKV) == tuple(
            n + 1 for n in before)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_stateful_v2_cell_runs_its_kernel_on_gpu(fuse, monkeypatch):
    """MatrixLSTMCell(64, 4) on the v2 name in eval, every parameter ~ 0.2
    N(0, 1), float32, from a random state at S 37 and 400: on the card one
    v2 inference launch a call (the fused LayerNorm entry under
    ``fuse_outnorm``), no step launch and no registry route; h and (C, n)
    against the same cell on the CPU (the plain versions) from the same
    state, within 1e-4 of each output's largest |value|."""
    needs_cuda()
    import copy

    from xlstm_yolo_tpu_torch.nn import layers

    def no_registry(cfg):
        raise AssertionError(f"the registry route was built: {cfg}")

    rng = np.random.default_rng(41)
    cpu = layers.MatrixLSTMCell(64, 4, fuse_outnorm=fuse).eval()
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.from_numpy(0.2 * rng.normal(size=p.shape)))
    gpu = copy.deepcopy(cpu).cuda()
    state = [rng.normal(size=s).astype(np.float32) for s in ((2, 4, 16, 16), (2, 4, 16))]
    for S in (37, 400):
        x = [rng.normal(size=(2, S, 64)).astype(np.float32) for _ in range(3)]
        with torch.no_grad():
            ref = cpu(*map(torch.from_numpy, x), state=tuple(map(torch.from_numpy, state)))
            monkeypatch.setattr(layers, "make_backend", no_registry)
            before = (chunkwise_v2.LAUNCHES, chunkwise_v2.LAUNCHES_LN, step.LAUNCHES)
            got = gpu(*map(cu, x), state=tuple(map(cu, state)))
            torch.cuda.synchronize()
            monkeypatch.undo()
        after = (chunkwise_v2.LAUNCHES, chunkwise_v2.LAUNCHES_LN, step.LAUNCHES)
        assert [a - b for a, b in zip(after, before)] == ([0, 1, 0] if fuse else [1, 0, 0])
        assert_rel_close([got[0].cpu(), *(t.cpu() for t in got[1])], [ref[0], *ref[1]], 1e-4)


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


STEP_CASES = [  # (B, NH, DH, gates, q/k/v as the inference wrapper's token view)
    (8, 12, 32, "open", False), (8, 12, 32, "closed", False),  # the flagship's heads
    (8, 3, 16, "open", False), (3, 3, 16, "closed", False),
    (8, 8, 64, "open", False), (3, 8, 64, "closed", False),    # vil-det-256's heads
    (8, 6, 128, "open", False), (8, 6, 128, "closed", False),  # vil-det-384's heads
    (3, 6, 128, "open", True), (8, 12, 32, "open", True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_kernel_matches_plain_on_gpu(dtype):
    """The step kernel against ``mlstm_siging_step`` at every detector's
    heads (DH 16 to 128, one to four 32-column slabs of C), B 8 and 3, open
    and closed forget gates, and q, k, v as the inference wrapper hands
    them (``x[:, :, 0]`` of a (B, NH, 1, DH) tensor): h in the storage
    type, (C', n') float32; one launch a call."""
    needs_cuda()
    dt = getattr(torch, dtype)
    for B, NH, DH, gates, view in STEP_CASES:
        rng = np.random.default_rng(NH + DH + (B != 8) * 1000 + view * 2000)
        shape = (B, NH, 1, DH) if view else (B, NH, DH)
        q, k, v = (cu(rng.normal(size=shape), dt) for _ in range(3))
        if view:
            q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]
        i = cu(rng.normal(0, 2, (B, NH)))
        f = cu(rng.normal(2, 1, (B, NH)) if gates == "open" else rng.uniform(-60, -20, (B, NH)))
        c, n = cu(rng.normal(size=(B, NH, DH, DH))), cu(rng.normal(size=(B, NH, DH)))
        before = step.LAUNCHES
        h, (c1, n1) = step.mlstm_siging_step_kernel(q, k, v, i, f, c, n, eps=EPS)
        torch.cuda.synchronize()
        assert step.LAUNCHES == before + 1 and h.dtype == dt and h.shape == (B, NH, DH)
        hp, (cp, np_) = mlstm_siging_step(q, k, v, i, f, c, n, eps=EPS)
        assert_rel_close([h], [hp], 1e-4 if dt == torch.float32 else 2e-2)
        assert_rel_close([c1, n1], [cp, np_], 1e-4)


@pytest.mark.cuda
def test_step_wrapper_launches_on_the_current_stream_on_gpu():
    """The wrapper's stream handle (PyTorch's raw getter) is the current
    stream's, on the default stream and inside ``torch.cuda.stream``; a
    call on a side stream gives the default stream's result, and the
    wrapper still refuses what the kernel does not take (a head dim outside
    HEAD_DIMS, mixed dtypes, a misaligned start)."""
    from xlstm_yolo_tpu_torch.ops import cuda_build

    needs_cuda()
    dev = torch.cuda.current_device()
    assert cuda_build.stream_handle(dev) == torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(5)
    q, k, v = (cu(rng.normal(size=(8, 6, 128))) for _ in range(3))
    i, f = cu(rng.normal(size=(8, 6))), cu(rng.normal(2, 1, (8, 6)))
    c, n = cu(rng.normal(size=(8, 6, 128, 128))), cu(rng.normal(size=(8, 6, 128)))
    h0, (c0, n0) = step.mlstm_siging_step_kernel(q, k, v, i, f, c, n, eps=EPS)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert cuda_build.stream_handle(dev) == side.cuda_stream
        h1, (c1, n1) = step.mlstm_siging_step_kernel(q, k, v, i, f, c, n, eps=EPS)
    side.synchronize()
    torch.cuda.synchronize()
    for a, b in ((h0, h1), (c0, c1), (n0, n1)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="head dim"):
        step.mlstm_siging_step_kernel(q[..., :48], k[..., :48], v[..., :48], i, f,
                                      c[..., :48, :48], n[..., :48], eps=EPS)
    with pytest.raises(ValueError, match="k must be"):
        step.mlstm_siging_step_kernel(q, k.bfloat16(), v, i, f, c, n, eps=EPS)
    flat = torch.zeros(8 * 6 * 128 + 1, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        step.mlstm_siging_step_kernel(flat[1:].view(8, 6, 128), k, v, i, f, c, n, eps=EPS)


def tal_inputs(seed, B, M, nc=80, size=640, first_valid=False):
    """Scores, predicted boxes near the anchors of a ``size`` px image
    (strides 8, 16, 32), padded gts (about half valid; with
    ``first_valid`` each image's first), labels, mask."""
    rng = np.random.default_rng(seed)
    pts = []
    for s in (8, 16, 32):
        n = size // s
        gy, gx = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5, indexing="ij")
        pts.append(np.stack([gx, gy], -1).reshape(-1, 2) * s)
    anc = np.concatenate(pts).astype(np.float32)
    A = len(anc)
    scores = 1 / (1 + np.exp(-rng.normal(-2, 1.5, (B, A, nc))))
    wh = rng.uniform(4, 160, (B, A, 2))
    ctr = anc[None] + rng.normal(0, 8, (B, A, 2))
    pboxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    gxy = rng.uniform(0, size - 40, (B, M, 2))
    gwh = rng.uniform(8, 300, (B, M, 2))
    gboxes = np.concatenate([gxy, np.minimum(gxy + gwh, size)], -1)
    mask = rng.uniform(0, 1, (B, M)) < 0.5
    if first_valid:
        mask[:, 0] = True
    gboxes[~mask] = 0.0
    labels = rng.integers(0, nc, (B, M))
    return (cu(scores), cu(pboxes), cu(anc), cu(labels, torch.int32), cu(gboxes),
            cu(mask, torch.bool))


def small_tal_inputs(seed, B, M, ties=False, degenerate=False, nc=11, A=200):
    """tests/test_torch_tal_metric.py's inputs: A anchors in a 320 px
    square, M gts (about 70 % valid), nc classes; ``ties``: gts of 20-60 px
    and predictions of 2-6 px, so most rows have fewer than k anchors of
    non-zero metric and the lowest index among zeros decides;
    ``degenerate``: image 0 without a valid gt, image 1 of zero-area gts."""
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 1, (B, A, nc)).astype(np.float32)
    anc = rng.uniform(0, 320, (A, 2)).astype(np.float32)
    pxy = rng.uniform(0, 280, (B, A, 2)).astype(np.float32)
    pwh = rng.uniform(*((2, 6) if ties else (5, 120)), (B, A, 2)).astype(np.float32)
    gxy = rng.uniform(0, 250, (B, M, 2)).astype(np.float32)
    gwh = rng.uniform(*((20, 60) if ties else (30, 160)), (B, M, 2)).astype(np.float32)
    gboxes = np.concatenate([gxy, gxy + gwh], -1)
    mask = rng.uniform(0, 1, (B, M)) > 0.3
    if degenerate:
        mask[0] = False
        gboxes[1] = 0.0
    return (cu(scores), cu(np.concatenate([pxy, pxy + pwh], -1)), cu(anc),
            cu(rng.integers(0, nc, (B, M)), torch.int32), cu(gboxes), cu(mask, torch.bool))


def tal_mask_without_nan(args, align, topk, karr, eps=1e-9):
    """mask_pos with a NaN metric never taken: the plain version's top-k
    rounds over align with each NaN as -inf (with a finite metric at every
    other anchor, a NaN then never wins a round), and the plain version's
    in-box mask."""
    _, _, anc, _, gb, mask_gt = args
    B, M, A = align.shape
    ax, ay = anc[:, 0][None, None], anc[:, 1][None, None]
    gx1, gy1, gx2, gy2 = (gb[..., j][..., None] for j in range(4))
    valid = ((ax - gx1 > eps) & (ay - gy1 > eps) & (gx2 - ax > eps) & (gy2 - ay > eps)
             & mask_gt[..., None])
    live = torch.where(torch.isnan(align), float("-inf"), align)
    iota = torch.arange(A, device=align.device)
    counts = (torch.full((B,), topk, device=align.device) if karr is None else karr)[:, None, None]
    sel = torch.zeros_like(valid)
    for r in range(topk):
        idx = torch.where(live == live.amax(-1, keepdim=True), iota, A).amin(-1, keepdim=True)
        oh = iota == idx
        sel |= oh & (r < counts)
        live = torch.where(oh, float("-inf"), live)
    return sel & valid


TAL_CASES = [  # (B, M, topk, per-sample k, inputs): 640 px (A 8400, nc 80) or small
    (2, 8, 10, None, "640"),
    (4, 24, 10, (10, 1, 10, 1), "640"),
    (1, 1, 10, None, "640"),        # one row: a cluster of 8 CTAs
    (1, 8, 10, None, "640"),
    (8, 8, 10, None, "640"),        # the smoke's gts
    (8, 128, 10, (10, 1) * 4, "640"),  # the dataset's max_targets, the E2E loss's k 10/1
    (8, 300, 10, None, "640"),      # 2400 rows: one CTA a row
    (8, 8, 1, None, "640"),         # topk 1
    (8, 8, 17, None, "640"),        # topk above the lists' 16 rows: two rounds
    (2, 128, 17, (17, 3), "640"),
    (3, 9, 10, None, "ties"),       # zero-metric ties decide
    (3, 9, 10, None, "degenerate"),  # no valid gt; zero-area gts
    (4, 9, 10, (10, 1, 10, 1), "small"),
    (3, 9, 10, None, "odd"),        # A 203, no multiple of 4: one anchor a step
    (2, 8, 10, None, "nan"),        # one predicted box NaN
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,topk,k_arr,inputs", TAL_CASES)
def test_tal_metric_kernel_matches_plain_on_gpu(B, M, topk, k_arr, inputs):
    """The TAL metric kernel against its plain version, one launch a call:
    align and overlaps bit-equal (NaN where it has NaN), mask_pos equal; with
    a NaN box, mask_pos as the kernel always took it (tal_mask_without_nan:
    the top-k of the row's other anchors), where the plain version's row max
    is NaN and takes nothing."""
    needs_cuda()
    if inputs in ("640", "nan"):
        args = tal_inputs(B + M, B, M, first_valid=True)
    else:
        args = small_tal_inputs(B + M, B, M, ties=inputs == "ties",
                                degenerate=inputs == "degenerate",
                                A=203 if inputs == "odd" else 200)
    if inputs == "nan":
        # a predicted box inside gt 0 of image 0 (its centre's anchor)
        pb, gb = args[1].clone(), args[4]
        anc = args[2]
        gx1, gy1, gx2, gy2 = gb[0, 0].tolist()
        inside = ((anc[:, 0] > gx1) & (anc[:, 0] < gx2) & (anc[:, 1] > gy1)
                  & (anc[:, 1] < gy2)).nonzero()
        assert len(inside) and bool(args[5][0, 0])
        pb[0, inside[0, 0], 2] = float("nan")
        args = (args[0], pb, *args[2:])
    nc = args[0].shape[-1]
    karr = None if k_arr is None else torch.tensor(k_arr, dtype=torch.int32, device="cuda")
    before = tal_metric.LAUNCHES
    got = tal_metric.tal_metric(*args, topk=topk, num_classes=nc, topk_arr=karr)
    torch.cuda.synchronize()
    assert tal_metric.LAUNCHES == before + 1
    ref = tal_metric.tal_metric_plain(*args, topk=topk, num_classes=nc, topk_arr=karr)
    for a, b in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    if inputs == "nan":
        assert torch.isnan(got[0]).any()
        assert torch.equal(got[2], tal_mask_without_nan(args, ref[0], topk, karr))
        assert not torch.equal(got[2], ref[2])  # the plain version takes none of that row
    else:
        assert torch.equal(got[2], ref[2])
    if inputs != "degenerate":
        assert got[2].any()


SLSTM_CASES = [  # (B, NH, DH, S, initial state, input gates + 12)
    (3, 4, 8, 37, False, False), (3, 4, 32, 97, True, False), (3, 2, 48, 20, True, True),
    (3, 4, 128, 128, True, True), (3, 4, 128, 300, False, False),
    (9, 4, 128, 64, True, False),   # a ragged last group of batch rows
    (9, 2, 48, 40, False, True),    # ragged rows, DH no multiple of the cluster's CTAs
    (3, 2, 256, 50, True, False),   # 16 CTAs a cluster (the non-portable size)
    (8, 4, 256, 97, False, True),
    (3, 2, 48, 2048, True, False),  # a long scan: float32 rounding compounds
    (3, 4, 128, 0, True, False), (9, 2, 48, 0, False, False),  # S 0: the initial state
]
SLSTM_REL = 1e-5  # chip_smoke.py's, and its float64 criterion (factor 2) beyond it


@pytest.mark.cuda
@pytest.mark.parametrize("B,NH,DH,S,state,big_i", SLSTM_CASES)
def test_slstm_kernel_matches_plain_on_gpu(B, NH, DH, S, state, big_i):
    """The sLSTM scan kernel against its plain loop (float32): hs and the
    last (h, c, n, m) within SLSTM_REL of each output's largest |value| or,
    at S 2048 only, where float32 rounding compounds beyond that, at most
    twice as far from the plain loop in float64 as the float32 plain loop
    is (+ SLSTM_REL of the largest |value|), as chip_smoke.py's
    phase_slstm_kernel; one launch a call; bfloat16 wx gives bfloat16 hs;
    at S 0 the last state is the initial one."""
    needs_cuda()
    rng = np.random.default_rng(DH + S + (B != 3) * B)
    wx = rng.normal(size=(B, S, 4, NH, DH))
    if big_i:
        wx[:, :, 1] += 12.0
    q, _ = np.linalg.qr(rng.normal(size=(4 * NH * DH, DH)))
    R = cu(q.reshape(4, NH, DH, DH))
    st = None
    if state:
        st = (cu(rng.normal(size=(B, NH, DH))), cu(rng.normal(size=(B, NH, DH))),
              cu(rng.uniform(0.5, 2, (B, NH, DH))), cu(rng.uniform(-2, 8, (B, NH, DH))))
    before = slstm.LAUNCHES
    hs, last = slstm.slstm_sequence(cu(wx), R, st)
    torch.cuda.synchronize()
    assert slstm.LAUNCHES == before + 1 and hs.shape == (B, S, NH * DH)
    hp, lp = slstm.slstm_sequence_plain(cu(wx), R, st)
    h64, l64 = slstm.slstm_sequence_plain(cu(wx, torch.float64), R.double(),
                                          None if st is None else tuple(t.double() for t in st))
    for name, a, b, r in zip(("hs", "h", "c", "n", "m"), (hs, *last), (hp, *lp), (h64, *l64)):
        assert torch.isfinite(a).all(), name
        scale = b.abs().max().item() if b.numel() else 0.0
        err = (a - b).abs().max().item() if b.numel() else 0.0
        if err > SLSTM_REL * scale:
            assert S >= 2048, (name, err, scale)  # the float64 criterion at long scans only
            err_k, err_p = ((t.double() - r).abs().max().item() for t in (a, b))
            assert err_k <= 2.0 * err_p + SLSTM_REL * scale, (name, err, err_k, err_p)
    if S == 0:
        want = st if st is not None else (torch.zeros(B, NH, DH, device="cuda"),) * 4
        for a, b in zip(last, want):
            assert torch.equal(a, b)
    hb, _ = slstm.slstm_sequence(cu(wx, torch.bfloat16), R, st)
    assert hb.dtype == torch.bfloat16 and slstm.LAUNCHES == before + 2


@pytest.mark.cuda
def test_slstm_plan_on_gpu():
    """The kernel's launch plan: K CTAs a cluster (a power of two up to 16),
    each owning U <= 8 NU units of a head (NU 4 a warp up to DH 64, else 2),
    ND 32-wide slices of d a lane, G of 1, 2 or 4 batch rows a cluster; at
    the LM's call (B 8, NH 4, DH 128) 8 CTAs of 16 units, at DH 32 one
    CTA."""
    needs_cuda()
    for B, NH, DH in ((8, 4, 128), (3, 4, 8), (9, 2, 48), (8, 4, 256), (64, 4, 128), (1, 1, 1)):
        p = slstm.plan(B, NH, DH)
        assert p["K"] in (1, 2, 4, 8, 16) and p["U"] * p["K"] >= DH
        assert p["NU"] == (4 if DH <= 64 else 2) and p["U"] <= 8 * p["NU"]
        assert p["G"] in (1, 2, 4)
        assert 32 * p["ND"] >= DH and (p["ND"] == 1 or 16 * p["ND"] < DH)
    assert {k: slstm.plan(8, 4, 128)[k] for k in ("K", "U")} == {"K": 8, "U": 16}
    assert slstm.plan(8, 4, 32)["K"] == 1


@pytest.mark.cuda
def test_slstm_cell_refuses_a_gradient_on_gpu():
    """The sLSTM kernel has no backward: on the card the cell runs under
    no_grad (one launch) and raises a ValueError where autograd would need
    its gradient."""
    needs_cuda()
    from xlstm_yolo_tpu_torch.nn.xlstm import sLSTMCell

    cell = sLSTMCell(64, 4).cuda()
    for p in cell.parameters():
        torch.nn.init.normal_(p, 0.0, 0.1)
    x = torch.randn(2, 9, 64, device="cuda")
    with pytest.raises(ValueError, match="no gradient"):
        cell(x)
    before = slstm.LAUNCHES
    with torch.no_grad():
        y, _ = cell(x)
    assert slstm.LAUNCHES == before + 1 and y.shape == x.shape


FW3_CASES = [  # (S, L, sub_chunk, NH, DH, gates, initial states)
    (200, 64, 32, 2, 16, "open", True),      # several chunks, ragged
    (900, 256, 128, 12, 32, "closed", False),  # ragged, the flagship's heads
    (100, 100, 128, 8, 64, "open", True),    # degenerate: Lb = L, not a whole row tile
    (512, 512, 256, 6, 128, "open", False),  # two sub-chunks of 256 (four row tiles)
    (1600, 400, 128, 6, 128, "closed", True),  # the v2 cell's S 1600 at vil-det-384's heads
    (203, 16, 8, 4, 32, "closed", True),     # Lb 8: half a 16-row tile, ragged
    (1000, 400, 100, 3, 64, "open", False),  # Lb 100: a whole and a ragged tile, ragged S
    (900, 400, 128, 12, 32, "open", True),   # Lb = L = 400: seven tiles, the last ragged
    (1500, 640, 300, 2, 128, "open", True),  # Lb = L = 640, above 512 rows: the gates' carry
    (1300, 640, 300, 4, 16, "closed", False),
]


def assert_rounding_shows(got, ref, ref_f32, min_gap=0.0):
    """With bfloat16 products: each output that a product feeds (all but
    n_last) lies within half the plain version's own bfloat16-vs-float32
    gap of the plain version, in mean |a - b| over mean |b|, so a kernel
    that skipped the operands' rounding would fail.  The mean is what a
    few operands rounded one step the other way barely move.  An output
    whose gap is at most ``min_gap`` of its mean |value| is one the
    products reach below float32's own resolution (a kernel's float32 sums
    in another order move it more than the rounding does), and is
    skipped."""
    for a, b, c in list(zip(got, ref, ref_f32))[:4]:
        if a is None:
            continue
        a, b, c = a.double(), b.double(), c.double()
        size = b.abs().mean().item()
        gap = (c - b).abs().mean().item()
        if size == 0 or gap <= min_gap * size:  # no product reaches it (the initial or
            continue                            # zero state), or below float32's resolution
        assert (a - b).abs().mean().item() < gap / 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,compute", V1_TYPES + [("bfloat16", "float32")])
def test_fw3_kernels_match_plain_on_gpu(dtype, compute):
    """Both variants of the fw3 kernels against the plain version on the
    same inputs, three launches a call: h within 1e-4 of its largest |value|
    (2e-2 where q or the products are bfloat16), the denominators and
    states within 1e-4 (2e-2 with bfloat16 products; with them also
    nearer the plain version than its float32-products twin is, as
    assert_rounding_shows reads it).  Then the drop-in contract at the v2
    kernels' L = 64 (sub-chunks 32 and 64): fw3's cstates and n_out are the
    v2 train forward's c_states and den (products in q's type, as the v2
    kernels'; 2e-2 in bfloat16), and the v2 backward kernel fed them gives
    the v2 path's dq, dk, dv and dC0."""
    needs_cuda()
    dt, ct = getattr(torch, dtype), getattr(torch, compute)
    h_rel = 1e-4 if dt == ct == torch.float32 else 2e-2
    s_rel = 1e-4 if ct == torch.float32 else 2e-2
    for S, L, Lb, NH, DH, gates, states in FW3_CASES:
        q, k, v, i, f, c0, n0 = make_inputs(S, 2, S, NH, DH, gates, states)
        args = (cu(q, dt), cu(k, dt), cu(v, dt), cu(i), cu(f), NH, cu(c0), cu(n0))
        kw = dict(chunk_size=L, sub_chunk=Lb, eps=EPS, compute_dtype=ct)
        ref = chunkwise_fw3.fw3_plain(*args, **kw)
        ref_f32 = (chunkwise_fw3.fw3_plain(*args, **{**kw, "compute_dtype": torch.float32})
                   if ct == torch.bfloat16 else None)
        for save in (True, False):
            before = chunkwise_fw3.LAUNCHES_FW3_TRAIN if save else chunkwise_fw3.LAUNCHES_FW3
            got = chunkwise_fw3.fw3(*args, save_states=save, **kw)
            torch.cuda.synchronize()
            after = chunkwise_fw3.LAUNCHES_FW3_TRAIN if save else chunkwise_fw3.LAUNCHES_FW3
            assert after == before + chunkwise_fw3.LAUNCHES_PER_CALL == before + 3
            outs = [(a, b, s_rel if j else h_rel)
                    for j, (a, b) in enumerate(zip(got, ref)) if a is not None]
            assert len(outs) == (5 if save else 3)
            for a, b, rel in outs:
                assert_rel_close([a], [b], rel)
            if ref_f32 is not None:
                assert_rounding_shows(got, ref, ref_f32)

    q, k, v, i, f, c0, n0 = make_inputs(5, 2, 1000, 12, 32, "open", True)
    args = (cu(q, dt), cu(k, dt), cu(v, dt), cu(i), cu(f), 12, cu(c0), cu(n0))
    dh = cu(np.random.default_rng(6).normal(size=q.shape), dt)
    dcl = cu(np.random.default_rng(7).normal(size=c0.shape))
    _, _, (c_states, _, den) = chunkwise_v2.mlstm_siging_chunkwise_fw_train(*args, eps=EPS)
    ref = chunkwise_v2.mlstm_siging_chunkwise_bw(*args[:6], c_states, den, dh, dcl, eps=EPS)
    for sub in (32, 64):  # products in the v2 kernels' type, q's
        _, n_out, cstates, _, _ = chunkwise_fw3.fw3(
            *args, chunk_size=chunkwise_v2.CHUNK_SIZE, sub_chunk=sub, eps=EPS, compute_dtype=dt)
        assert_rel_close([cstates], [c_states],
                         1e-4 if dt == torch.float32 else BF16_STATE_REL)
        assert_rel_close([n_out], [den], 1e-4 if dt == torch.float32 else 2e-2)
        got = chunkwise_v2.mlstm_siging_chunkwise_bw(*args[:6], cstates, n_out, dh, dcl, eps=EPS)
        assert_grads_close(got, ref, dt)


# -- the validation path ------------------------------------------------------

VAL_SHAPES = [(480, 640), (375, 500), (333, 500), (1080, 1920), (150, 200), (640, 640),
              (97, 211), (960, 1280)]


def write_png_set(root, shapes, seed):
    """PNG images (gradients plus noise) of ``shapes``, no labels; the
    dataset YAML (80 classes)."""
    import yaml

    from xlstm_yolo_tpu_torch.data.imread import imwrite_png

    rng = np.random.default_rng(seed)
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    for j, (h, w) in enumerate(shapes):
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1)
        im = (base + rng.integers(-40, 40, (h, w, 3))).clip(0, 255).astype(np.uint8)
        imwrite_png(root / "images" / "val" / f"im{j:02d}.png", im, level=1)
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(root), "val": "images/val",
                                    "names": [f"c{i}" for i in range(80)]}))
    return data


@pytest.mark.cuda
def test_val_pixels_on_gpu_equal_cpu(tmp_path):
    """The val pre-resize and letterbox on the card give the CPU's bytes
    (which equal OpenCV's: tests/test_torch_val.py), 2x area-path
    downscales and ceil upscales included."""
    needs_cuda()
    from xlstm_yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset

    data = write_png_set(tmp_path, VAL_SHAPES, seed=1)
    ds = YOLODataset(check_det_dataset(str(data))["val"], imgsz=640)
    batch = ds.collate([ds.get_sample(i) for i in range(len(ds))])
    on_gpu = ds.images(batch, "cuda")
    assert on_gpu.is_cuda and on_gpu.shape == (len(VAL_SHAPES), 640, 640, 3)
    assert torch.equal(on_gpu.cpu(), ds.images(batch, "cpu"))


@pytest.mark.cuda
def test_tiny_self_labelled_val_on_gpu(tmp_path):
    """vil-det-tiny (bf16, the port's random weights with short boxes) on the
    card: its top 20 detections an image written back as labels, then
    validated at max_det 20: mAP50-95 >= 0.95, 14 launches a batch."""
    needs_cuda()
    from xlstm_yolo_tpu_torch.engine.model import YOLO
    from xlstm_yolo_tpu_torch.nn.head import Detect

    shapes = [(120, 160), (97, 211), (160, 160), (200, 150), (75, 100), (333, 500), (64, 48),
              (150, 200)]
    data = write_png_set(tmp_path / "set", shapes, seed=2)
    yolo = YOLO("vil-det-tiny.yaml")
    head = next(m for m in yolo.model.modules() if isinstance(m, Detect))
    with torch.no_grad():  # distances of ~1.5 DFL bins: distinct boxes once clipped
        for box in head.one2one_cv2:
            box[-1].weight.mul_(0.1)
            box[-1].bias.copy_(-0.5 * torch.arange(16.0).repeat(4))
    chunkwise_v2.LAUNCHES = 0
    yolo.val(data=str(data), batch=4, workers=0, save_json=True, save_dir=tmp_path / "pass1")
    assert chunkwise_v2.LAUNCHES == 2 * 14
    for j, (h, w) in enumerate(shapes):
        rows = [r for r in yolo.validator.jdict if r["image_id"] == f"im{j:02d}"][:20]
        (tmp_path / "set" / "labels" / "val" / f"im{j:02d}.txt").write_text("".join(
            f"{r['category_id']} {(r['bbox'][0] + r['bbox'][2] / 2) / w:.7f} "
            f"{(r['bbox'][1] + r['bbox'][3] / 2) / h:.7f} {r['bbox'][2] / w:.7f} "
            f"{r['bbox'][3] / h:.7f}\n" for r in rows))
    res = yolo.val(data=str(data), batch=4, workers=0, max_det=20)
    assert yolo.validator.seen == len(shapes)
    assert res["metrics/mAP50-95(B)"] >= 0.95, res


@pytest.mark.cuda
def test_pt_checkpoint_round_trip_on_gpu(tmp_path):
    """A saved vil-det-192 state dict loads back through YOLO(".pt") on the
    card, tensor for tensor (no forward)."""
    needs_cuda()
    from xlstm_yolo_tpu_torch.engine.model import YOLO

    yolo = YOLO("vil-det-192.yaml")
    g = torch.Generator(device="cuda").manual_seed(3)
    sd = {k: (v + torch.rand(v.shape, generator=g, device=v.device) if v.is_floating_point()
              else v).cpu() for k, v in yolo.model.state_dict().items()}
    torch.save({"ema": sd, "model": None}, tmp_path / "w.pt")
    back = YOLO(str(tmp_path / "w.pt"))
    got = back.model.state_dict()
    assert back.device.type == "cuda" and got.keys() == sd.keys()
    for k, v in got.items():
        assert v.is_cuda and torch.equal(v.cpu(), sd[k]), k


# ---------------------------------------------------------------------------
# other input sizes: the v2 kernels at vil-det-192's lengths at 768 px (S 9216
# at its first stage) and its ragged last stage (S 144: two chunks of 64 and 16
# rows), and the resize of utils/resize.py on the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [9216, 144])
def test_v2_kernels_at_multiscale_lengths_on_gpu(S, dtype):
    """The inference forward, the train forward and the backward at B 2,
    NH 12, DH 32 against their plain versions, at this file's tolerances
    (bfloat16 h and C against the two plain passes)."""
    needs_cuda()
    dt = getattr(torch, dtype)
    NH, DH = 12, 32
    q, k, v, i, f, c0, n0 = make_inputs(S + 5, 2, S, NH, DH, "open", True)
    args = (cu(q, dt), cu(k, dt), cu(v, dt), cu(i), cu(f), NH, cu(c0), cu(n0))
    h, (c, n) = chunkwise_v2.mlstm_siging_chunkwise_fw(*args, eps=EPS, return_last_states=True)
    ht, (ct, nt), (cs, ns, den) = chunkwise_v2.mlstm_siging_chunkwise_fw_train(*args, eps=EPS)
    torch.cuda.synchronize()
    if dt == torch.float32:
        hp, (cp, np_) = chunkwise_v2.mlstm_siging_chunkwise_fw_plain(*args, eps=EPS,
                                                                     return_last_states=True)
        assert_rel_close([h, c, n], [hp, cp, np_], 1e-4)
        ref = chunkwise_v2.mlstm_siging_chunkwise_fw_train_plain(*args, eps=EPS)
        assert_rel_close([ht, ct, nt, cs, ns, den], [ref[0], *ref[1], *ref[2]], 1e-4)
    else:
        sh, sden, scs, sns, sc, sn = fw_split_plain(args)
        assert_rel_close([h, ht], [sh, sh], 2e-2)
        assert_rel_close([c, ct, cs], [sc, sc, scs], BF16_STATE_REL)
        assert_rel_close([n, nt, ns, den], [sn, sn, sns, sden], 1e-4)
    rng = np.random.default_rng(S)
    dh = cu(rng.normal(size=q.shape), dt)
    dc_last = cu(rng.normal(size=(2, NH, DH, DH)))
    bw = (*args[:6], cs, den, dh, dc_last)
    got = chunkwise_v2.mlstm_siging_chunkwise_bw(*bw, eps=EPS)
    ref = chunkwise_v2.mlstm_siging_chunkwise_bw_plain(*bw, eps=EPS)
    assert_grads_close(got[:3], ref[:3], dt)
    assert_grads_close(got[3:], ref[3:], torch.float32 if dt == torch.float32 else dt)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_in,shape_out,method", [
    ((10, 10, 192), (8, 8, 192), "bicubic"),            # a PatchMerger's query grid
    ((1, 80, 80, 192), (1, 96, 96, 192), "bicubic"),     # vil-det-192's pos embed at 768
    ((4, 640, 640, 3), (4, 512, 512, 3), "bilinear"),    # a bucket's batch
])
def test_resize_on_gpu_matches_cpu(shape_in, shape_out, method):
    """utils/resize.py on CUDA tensors against its CPU result, value and
    gradient, within 1e-5 of the largest |value|."""
    needs_cuda()
    from xlstm_yolo_tpu_torch.utils.resize import resize

    rng = np.random.default_rng(len(shape_in) + shape_out[-2])
    x = rng.normal(size=shape_in).astype(np.float32)
    w = rng.normal(size=shape_out).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        y = resize(xt, shape_out, method)
        (g,) = torch.autograd.grad((y * torch.from_numpy(w).to(dev)).sum(), xt)
        out[dev] = (y.detach().cpu(), g.cpu())
    assert_rel_close(list(out["cuda"]), list(out["cpu"]), 1e-5)
