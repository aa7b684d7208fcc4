"""Chunkwise exponential-input-gate mLSTM with the max stabilizer m, in the
(B, NH, S, DH) layout: the CUDA kernels, their wrappers, their plain
PyTorch versions and the autograd Function.

Counterpart of ``xlstm_yolo_tpu/ops/pallas/chunkwise_exp.py``, the
registry's ``chunkwise--pallas_xl_chunk``.  The input gate is e^i, which
can exceed 1, so a running max m per (batch, head) is carried across the
chunks and C and n are stored relative to it:

    m_k  = max(g + m_{k-1}, max_l a_l)
    C_k  = e^{(g + m_{k-1}) - m_k} C_{k-1} + (e^{a - m_k} k)^T v,   n_k likewise
    m_c  = max(b_l + m_{k-1}, max_{j <= l} ((b_l - b_j) + i_j))   per row l
    h    = (e^{(b + m_{k-1}) - m_c} qs C_{k-1} + (qs k^T * e^{logD - m_c}) v)
           / (max(|...|, e^{-m_c}) + eps)

with b = cumsum logsig(f) in the chunk, g = b[L - 1], a = (g - b) + i.

- :func:`chunkwise_exp_fw` — ``_fw``: h, and in training (``save_states``)
  the denominator and m_comb of each row and C and m before each chunk;
  the last (C, n, m) always (``_fw_kernel``), kernel ``chunkwise_exp_fw``
  in ``csrc/chunkwise_exp_fw.cu``;
- :func:`chunkwise_exp_bw_dc` — the reverse scan of the dC states
  (``_bw_dc_kernel``), kernel ``chunkwise_exp_bw_dc`` in
  ``csrc/chunkwise_exp_bw.cu``;
- :func:`chunkwise_exp_bw_dqkv` — dq, dk, dv per chunk in the input dtype
  (``_bw_dqkv_kernel``), kernel ``chunkwise_exp_bw_dqkv`` in the same file;
- :func:`chunkwise_exp_bw` — ``_bw``: the per-chunk m rows, both backward
  kernels and the gate gradients;
- :func:`mlstm_chunkwise_exp` — ``mlstm_chunkwise_exp_pallas``, the
  differentiable function (``_core`` with ``_core_fwd`` and ``_core_bwd``).
  The stabilizers and the denominator are constants of its gradient.

The chunk length L is the caller's (S a multiple of it) and part of the
function: the products round their operands to ``compute_dtype`` (bfloat16
by default, as the JAX entry) and sum in float32, at the points where the
Pallas kernels cast; the row sums stay unrounded.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
``*_plain`` version for CPU tensors.  ``LAUNCHES_FW``, ``LAUNCHES_BW_DC`` and
``LAUNCHES_BW_DQKV`` count kernel calls (the forward's call is two
launches, the state scan and h, counted once).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xlstm_yolo_tpu_torch.ops import cuda_build
from xlstm_yolo_tpu_torch.ops.chunkwise import (
    _check,
    _check_cuda,
    _check_saved,
    _chunks,
    _codes,
    _rounder,
)
from xlstm_yolo_tpu_torch.ops.cuda_build import F as CF
from xlstm_yolo_tpu_torch.ops.cuda_build import I, P
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = [
    "LAUNCHES_BW_DC",
    "LAUNCHES_BW_DQKV",
    "LAUNCHES_FW",
    "chunkwise_exp_bw",
    "chunkwise_exp_bw_dc",
    "chunkwise_exp_bw_dc_plain",
    "chunkwise_exp_bw_dqkv",
    "chunkwise_exp_bw_dqkv_plain",
    "chunkwise_exp_fw",
    "chunkwise_exp_fw_plain",
    "m_rows",
    "mlstm_chunkwise_exp",
]

LAUNCHES_FW = 0       # calls of the forward kernels
LAUNCHES_BW_DC = 0    # launches of the dC reverse-scan kernel
LAUNCHES_BW_DQKV = 0  # launches of the dq/dk/dv kernel


def _declare_fw(lib):
    lib.chunkwise_exp_fw.argtypes = [P] * 17 + [I] * 7 + [CF, CF, P]
    lib.chunkwise_exp_fw.restype = I


def _declare_bw(lib):
    lib.chunkwise_exp_bw_dc.argtypes = [P] * 9 + [I] * 7 + [CF, CF, P]
    lib.chunkwise_exp_bw_dqkv.argtypes = [P] * 14 + [I] * 7 + [CF, CF, P]
    lib.chunkwise_exp_bw_dc.restype = lib.chunkwise_exp_bw_dqkv.restype = I


def _check_m(q, c_initial, m_initial):
    if m_initial is None:
        return
    B, NH = q.shape[:2]
    if c_initial is None:
        raise ValueError("m_initial needs c_initial and n_initial")
    if m_initial.shape != (B, NH) or m_initial.dtype != acc_dtype(q.dtype):
        raise ValueError(f"m_initial must be {acc_dtype(q.dtype)} {(B, NH)}")
    if m_initial.device != q.device:
        raise ValueError(f"all inputs must be on {q.device}, got {m_initial.device}")


# ---------------------------------------------------------------------------
# plain versions: the JAX kernels' arithmetic, chunks as a batch dimension
# ---------------------------------------------------------------------------


def _gates(i, f, L):
    """Per-chunk gate rows (B, NH, NC, L): b = cumsum logsig(f), a = (g - b)
    + i, the raw input gate i; and g = b[..., -1] (B, NH, NC)."""
    B, NH, S = f.shape
    logf = F.logsigmoid(f).reshape(B, NH, S // L, L)
    ic = i.reshape(B, NH, S // L, L)
    b = torch.cumsum(logf, dim=-1)
    g = b[..., -1]
    return b, (g[..., None] - b) + ic, ic, g


def _log_decay(b, ic):
    """logD = (b_l - b_j) + i_j on and below the diagonal, -inf above."""
    L = b.shape[-1]
    causal = torch.ones(L, L, dtype=torch.bool, device=b.device).tril()
    logD = b[..., :, None] - b[..., None, :] + ic[..., None, :]
    return torch.where(causal, logD, torch.full((), -torch.inf, dtype=b.dtype, device=b.device))


def chunkwise_exp_fw_plain(q, k, v, i, f, c_initial=None, n_initial=None, m_initial=None,
                           chunk_size: int = 128, qk_scale: float | None = None,
                           eps: float = 1e-6, compute_dtype=torch.bfloat16,
                           save_states: bool = True):
    """Plain version of :func:`chunkwise_exp_fw`, on any device (float64 too)."""
    B, NH, S, DH = _check(q, k, v, i, f, chunk_size, compute_dtype, c_initial, n_initial)
    _check_m(q, c_initial, m_initial)
    L, NC = chunk_size, S // chunk_size
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    acc = acc_dtype(q.dtype)
    R = _rounder(compute_dtype, acc)
    qc, kc, vc = (_chunks(x.to(acc), L) for x in (q, k, v))
    b, a, ic, g = _gates(i, f, L)
    C = c_initial.to(acc) if c_initial is not None else q.new_zeros(B, NH, DH, DH, dtype=acc)
    n = n_initial.to(acc) if n_initial is not None else q.new_zeros(B, NH, DH, dtype=acc)
    m = m_initial.to(acc) if m_initial is not None else q.new_zeros(B, NH, dtype=acc)
    a_max = a.amax(-1)
    Rv = R(vc)
    c_states, n_states, m_states = [], [], []
    for c in range(NC):  # the state before each chunk
        c_states.append(C)
        n_states.append(n)
        m_states.append(m)
        m_new = torch.maximum(g[..., c] + m, a_max[..., c])
        gbar = torch.exp((g[..., c] + m) - m_new)
        kbar = kc[:, :, c] * torch.exp(a[:, :, c] - m_new[..., None])[..., None]
        C = gbar[..., None, None] * C + R(kbar).transpose(-1, -2) @ Rv[:, :, c]
        n = gbar[..., None] * n + kbar.sum(-2)
        m = m_new
    c_states, n_states = torch.stack(c_states, dim=2), torch.stack(n_states, dim=2)
    m_states = torch.stack(m_states, dim=2)
    logD = _log_decay(b, ic)
    m_comb = torch.maximum(b + m_states[..., None], logD.amax(-1))
    sd = (R(qc) @ R(kc).transpose(-1, -2)) * scale * torch.exp(logD - m_comb[..., None])
    qbar = qc * torch.exp((b + m_states[..., None]) - m_comb)[..., None] * scale
    num = R(sd) @ R(vc) + R(qbar) @ R(c_states)
    den_raw = sd.sum(-1) + (qbar * n_states[..., None, :]).sum(-1)
    den = torch.maximum(den_raw.abs(), torch.exp(-m_comb))
    h = (num / (den[..., None] + eps)).reshape(B, NH, S, DH).to(q.dtype)
    if not save_states:
        return h, None, None, None, None, (C, n, m)
    return h, den.reshape(B, NH, S), m_comb.reshape(B, NH, S), c_states, m_states, (C, n, m)


def chunkwise_exp_bw_dc_plain(q, f, dh, den, m_comb, mrow, dc_last=None, chunk_size: int = 128,
                              qk_scale: float | None = None, eps: float = 1e-6,
                              compute_dtype=torch.bfloat16):
    """Plain version of :func:`chunkwise_exp_bw_dc`."""
    B, NH, S, DH = q.shape
    _check_saved(q, chunk_size, dh=dh, den=den, m_comb=m_comb, mrow=mrow, dc_last=dc_last)
    L, NC = chunk_size, S // chunk_size
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    acc = acc_dtype(q.dtype)
    R = _rounder(compute_dtype, acc)
    b, _, _, _ = _gates(torch.zeros_like(f), f, L)
    m_prev, gbar = mrow[..., 0], mrow[..., 1]
    qf = torch.exp((b + m_prev[..., None]) - m_comb.reshape(B, NH, NC, L))
    qbar = _chunks(q.to(acc), L) * qf[..., None] * scale
    dhn = _chunks(dh.to(acc), L) / (den.reshape(B, NH, NC, L, 1) + eps)
    inc = R(qbar).transpose(-1, -2) @ R(dhn)  # (B, NH, NC, DH, DH)
    dC = dc_last.to(acc) if dc_last is not None else q.new_zeros(B, NH, DH, DH, dtype=acc)
    dc_states = [None] * NC
    for c in range(NC - 1, -1, -1):  # the gradient of the state after each chunk
        dc_states[c] = dC
        dC = gbar[..., c, None, None] * dC + inc[:, :, c]
    return torch.stack(dc_states, dim=2), dC


def chunkwise_exp_bw_dqkv_plain(q, k, v, i, f, c_states, den, m_comb, mrow, dh, dc_states,
                                chunk_size: int = 128, qk_scale: float | None = None,
                                eps: float = 1e-6, compute_dtype=torch.bfloat16):
    """Plain version of :func:`chunkwise_exp_bw_dqkv`."""
    B, NH, S, DH = _check(q, k, v, i, f, chunk_size, compute_dtype)
    _check_saved(q, chunk_size, c_states=c_states, den=den, m_comb=m_comb, mrow=mrow, dh=dh,
                 dc_states=dc_states)
    L, NC = chunk_size, S // chunk_size
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    acc = acc_dtype(q.dtype)
    R = _rounder(compute_dtype, acc)
    qc, kc, vc = (_chunks(x.to(acc), L) for x in (q, k, v))
    b, a, ic, _ = _gates(i, f, L)
    mc = m_comb.reshape(B, NH, NC, L)
    m_prev, m_new = mrow[..., 0, None], mrow[..., 1, None]
    D = torch.exp(_log_decay(b, ic) - mc[..., None])
    dhn = _chunks(dh.to(acc), L) / (den.reshape(B, NH, NC, L, 1) + eps)
    Pm = (R(dhn) @ R(vc).transpose(-1, -2)) * D
    sd = (R(qc) @ R(kc).transpose(-1, -2)) * scale * D
    expb = torch.exp((b + m_prev) - mc)[..., None]
    expa = torch.exp(a - m_new)[..., None]
    dq = (R(Pm) @ R(kc)) * scale + (R(dhn) @ R(c_states).transpose(-1, -2)) * (expb * scale)
    dk = (R(Pm).transpose(-1, -2) @ R(qc)) * scale \
        + (R(vc) @ R(dc_states).transpose(-1, -2)) * expa
    dv = R(sd).transpose(-1, -2) @ R(dhn) + R(kc * expa) @ R(dc_states)
    return tuple(x.reshape(B, NH, S, DH).to(q.dtype) for x in (dq, dk, dv))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def chunkwise_exp_fw(q, k, v, i, f, c_initial=None, n_initial=None, m_initial=None,
                     chunk_size: int = 128, qk_scale: float | None = None, eps: float = 1e-6,
                     compute_dtype=torch.bfloat16, save_states: bool = True):
    """The exp forward.

    q, k, v: (B, NH, S, DH) float32 or bfloat16; i, f: (B, NH, S) float32
    pre-activations (i the raw exponent of the input gate); optional
    c_initial (B, NH, DH, DH), n_initial (B, NH, DH) and m_initial (B, NH)
    float32 (m zero when only C and n are given); S a multiple of
    ``chunk_size``.  Returns h in q's dtype; with ``save_states``, in
    float32, the denominator max(|.|, e^{-m_comb}) and m_comb of each row
    (B, NH, S), C before each chunk (B, NH, NC, DH, DH) and m before each
    chunk (B, NH, NC), else four Nones; and the last (C, n, m).

    CUDA tensors go through the hand-written kernels (or this raises); CPU
    tensors go through the plain version.
    """
    global LAUNCHES_FW
    if q.device.type == "cpu":
        return chunkwise_exp_fw_plain(q, k, v, i, f, c_initial, n_initial, m_initial,
                                      chunk_size, qk_scale, eps, compute_dtype, save_states)
    B, NH, S, DH = _check(q, k, v, i, f, chunk_size, compute_dtype, c_initial, n_initial)
    _check_m(q, c_initial, m_initial)
    _check_cuda(q, chunk_size, compute_dtype, [q, k, v, i, f, c_initial, n_initial, m_initial])
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    NC = S // chunk_size
    lib = cuda_build.load("chunkwise_exp_fw", _declare_fw)
    opts = dict(dtype=torch.float32, device=q.device)
    h = torch.empty_like(q)
    den = torch.empty(B, NH, S, **opts) if save_states else None
    m_comb = torch.empty(B, NH, S, **opts) if save_states else None
    c_states = torch.empty(B, NH, NC, DH, DH, **opts)
    n_states = torch.empty(B, NH, NC, DH, **opts)  # read by the h launch only
    m_states = torch.empty(B, NH, NC, **opts)
    c_last = torch.empty(B, NH, DH, DH, **opts)
    n_last = torch.empty(B, NH, DH, **opts)
    m_last = torch.empty(B, NH, **opts)
    with torch.cuda.device(q.device):
        cuda_build.launch(
            lib.chunkwise_exp_fw, "chunkwise_exp_fw",
            *cuda_build.pointers(q, k, v, i, f, c_initial, n_initial, m_initial, h, den, m_comb,
                                 c_states, n_states, m_states, c_last, n_last, m_last),
            B, NH, S, DH, chunk_size, *_codes(q, compute_dtype), float(scale), float(eps))
    LAUNCHES_FW += 1
    state = (c_last, n_last, m_last)
    if not save_states:
        return h, None, None, None, None, state
    return h, den, m_comb, c_states, m_states, state


def chunkwise_exp_bw_dc(q, f, dh, den, m_comb, mrow, dc_last=None, chunk_size: int = 128,
                        qk_scale: float | None = None, eps: float = 1e-6,
                        compute_dtype=torch.bfloat16):
    """The reverse scan dC_{k-1} = gbar_k dC_k + Qbar_k^T (dh_k / (den_k + eps)),
    Qbar = q e^{(b + m_prev) - m_comb} scale; ``mrow`` (B, NH, NC, 2) holds
    [m_prev, gbar] per chunk.

    Returns dc_states (B, NH, NC, DH, DH), the gradient of the state after
    each chunk (slot NC - 1 holds ``dc_last`` or zeros), and dc0
    (B, NH, DH, DH), that of the state before the first chunk; float32.
    """
    global LAUNCHES_BW_DC
    if q.device.type == "cpu":
        return chunkwise_exp_bw_dc_plain(q, f, dh, den, m_comb, mrow, dc_last, chunk_size,
                                         qk_scale, eps, compute_dtype)
    B, NH, S, DH = q.shape
    _check_saved(q, chunk_size, dh=dh, den=den, m_comb=m_comb, mrow=mrow, dc_last=dc_last)
    if f.shape != (B, NH, S) or f.dtype != torch.float32 or S % chunk_size:
        raise ValueError(f"f must be float32 {(B, NH, S)} and S a multiple of {chunk_size}")
    _check_cuda(q, chunk_size, compute_dtype, [q, f, dh, den, m_comb, mrow, dc_last])
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    lib = cuda_build.load("chunkwise_exp_bw", _declare_bw)
    dc_states = torch.empty(B, NH, S // chunk_size, DH, DH, dtype=torch.float32, device=q.device)
    dc0 = torch.empty(B, NH, DH, DH, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        cuda_build.launch(
            lib.chunkwise_exp_bw_dc, "chunkwise_exp_bw_dc",
            *cuda_build.pointers(q, f, dh, den, m_comb, mrow, dc_last, dc_states, dc0),
            B, NH, S, DH, chunk_size, *_codes(q, compute_dtype), float(scale), float(eps))
    LAUNCHES_BW_DC += 1
    return dc_states, dc0


def chunkwise_exp_bw_dqkv(q, k, v, i, f, c_states, den, m_comb, mrow, dh, dc_states,
                          chunk_size: int = 128, qk_scale: float | None = None,
                          eps: float = 1e-6, compute_dtype=torch.bfloat16):
    """dq, dk, dv (B, NH, S, DH) in q's dtype of every chunk, independently,
    from the saved state before the chunk and the gradient of the state
    after it; ``mrow`` (B, NH, NC, 2) holds [m_prev, m_new] per chunk.  With
    dhn = dh / (den + eps), D = tril(e^{logD - m_comb}), P = (dhn v^T) * D,

        dq = scale (P k + e^{(b + m_prev) - m_comb} dhn C_prev^T),
        dk = scale P^T q + e^{a - m_new} (v dC^T),   dv = (S * D)^T dhn + (e^{a - m_new} k) dC.
    """
    global LAUNCHES_BW_DQKV
    if q.device.type == "cpu":
        return chunkwise_exp_bw_dqkv_plain(q, k, v, i, f, c_states, den, m_comb, mrow, dh,
                                           dc_states, chunk_size, qk_scale, eps, compute_dtype)
    B, NH, S, DH = _check(q, k, v, i, f, chunk_size, compute_dtype)
    _check_saved(q, chunk_size, c_states=c_states, den=den, m_comb=m_comb, mrow=mrow, dh=dh,
                 dc_states=dc_states)
    _check_cuda(q, chunk_size, compute_dtype,
                [q, k, v, i, f, c_states, den, m_comb, mrow, dh, dc_states])
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    lib = cuda_build.load("chunkwise_exp_bw", _declare_bw)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        cuda_build.launch(
            lib.chunkwise_exp_bw_dqkv, "chunkwise_exp_bw_dqkv",
            *cuda_build.pointers(q, k, v, i, f, c_states, den, m_comb, mrow, dh, dc_states, dq,
                                 dk, dv),
            B, NH, S, DH, chunk_size, *_codes(q, compute_dtype), float(scale), float(eps))
    LAUNCHES_BW_DQKV += 1
    return dq, dk, dv


def m_rows(f, m_states, m_last, chunk_size: int):
    """The per-chunk rows of ``_bw``: [m_prev, gbar] for the dC scan and
    [m_prev, m_new] for dq/dk/dv, (B, NH, NC, 2) each, with m_new the next
    chunk's m_prev (m_last after the last) and gbar = e^{(g + m_prev) -
    m_new}, g the chunk's sum of logsig(f)."""
    B, NH, S = f.shape
    g = F.logsigmoid(f).reshape(B, NH, S // chunk_size, chunk_size).sum(-1)
    m_new = torch.cat([m_states[..., 1:], m_last[..., None]], dim=-1)
    gbar = torch.exp((g + m_states) - m_new)
    return (torch.stack([m_states, gbar], dim=-1).contiguous(),
            torch.stack([m_states, m_new], dim=-1).contiguous())


def chunkwise_exp_bw(q, k, v, i, f, den, m_comb, c_states, m_states, m_last, dh, dc_last=None,
                     chunk_size: int = 128, qk_scale: float | None = None, eps: float = 1e-6,
                     compute_dtype=torch.bfloat16):
    """``_bw``: the m rows, the dC scan, dq/dk/dv, and the gate gradients
    from dq and dk in the input dtype: di = k.dk (the raw exponential gate),
    df = revcumsum(q.dq - k.dk) sigmoid(-f).  Returns dq, dk, dv in q's
    dtype, di, df and dc0 (the gradient of C before the first chunk, in the
    scaling of m_initial)."""
    kw = dict(chunk_size=chunk_size, qk_scale=qk_scale, eps=eps, compute_dtype=compute_dtype)
    mrow_dc, mrow_qkv = m_rows(f, m_states, m_last, chunk_size)
    dc_states, dc0 = chunkwise_exp_bw_dc(q, f, dh, den, m_comb, mrow_dc, dc_last, **kw)
    dq, dk, dv = chunkwise_exp_bw_dqkv(q, k, v, i, f, c_states, den, m_comb, mrow_qkv, dh,
                                       dc_states, **kw)
    acc = acc_dtype(q.dtype)
    kdk = (k.to(acc) * dk.to(acc)).sum(-1)
    dfbar = (q.to(acc) * dq.to(acc)).sum(-1) - kdk
    df = dfbar.flip(-1).cumsum(-1).flip(-1) * torch.sigmoid(-f)
    return dq, dk, dv, kdk, df, dc0


class _ChunkwiseExp(torch.autograd.Function):
    """``_core`` with ``_core_fwd`` / ``_core_bwd``: the gradient of c_initial
    is dc0 and those of n_initial and m_initial zeros when initial states
    were given; the gradients of n_last and m_last are dropped, and df has
    no dC_last term, as in the JAX VJP."""

    @staticmethod
    def forward(ctx, q, k, v, i, f, c_initial, n_initial, m_initial, chunk_size, qk_scale, eps,
                compute_dtype):
        h, den, m_comb, c_states, m_states, (c_last, n_last, m_last) = chunkwise_exp_fw(
            q, k, v, i, f, c_initial, n_initial, m_initial, chunk_size, qk_scale, eps,
            compute_dtype, save_states=True)
        ctx.save_for_backward(q, k, v, i, f, den, m_comb, c_states, m_states, m_last)
        ctx.kw = dict(chunk_size=chunk_size, qk_scale=qk_scale, eps=eps,
                      compute_dtype=compute_dtype)
        ctx.init_shapes = None if c_initial is None else (n_initial.shape, m_initial.shape)
        ctx.mark_non_differentiable(n_last, m_last)
        ctx.set_materialize_grads(False)
        return h, c_last, n_last, m_last

    @staticmethod
    def backward(ctx, dh, dc_last, _dn_last, _dm_last):
        q, k, v, i, f, den, m_comb, c_states, m_states, m_last = ctx.saved_tensors
        dh = torch.zeros_like(q) if dh is None else dh.contiguous()
        dc_last = None if dc_last is None else dc_last.contiguous()
        dq, dk, dv, di, df, dc0 = chunkwise_exp_bw(q, k, v, i, f, den, m_comb, c_states,
                                                   m_states, m_last, dh, dc_last, **ctx.kw)
        if ctx.init_shapes is None:
            return dq, dk, dv, di, df, None, None, None, None, None, None, None
        dni, dmi = (dc0.new_zeros(s) for s in ctx.init_shapes)
        return dq, dk, dv, di, df, dc0, dni, dmi, None, None, None, None


def mlstm_chunkwise_exp(q, k, v, i, f, chunk_size: int = 128, c_initial=None, n_initial=None,
                        m_initial=None, qk_scale: float | None = None,
                        return_last_states: bool = False, eps: float = 1e-6,
                        compute_dtype=torch.bfloat16):
    """The registry's ``chunkwise--pallas_xl_chunk``: the exp kernels (plain
    versions on CPU tensors).  (B, NH, S, DH) streams, (B, NH, S) gates, S a
    multiple of ``chunk_size``; returns h, and (C, n, m) with
    ``return_last_states``, C and n relative to m.  With c_initial and no
    m_initial, m starts at zeros.  When no input needs a gradient the
    forward saves nothing for a backward (the predict path).  Views (the
    inference wrapper's segments) are copied to contiguous tensors for the
    kernels."""
    if c_initial is not None and m_initial is None:
        m_initial = torch.zeros(q.shape[:2], dtype=acc_dtype(q.dtype), device=q.device)
    ins = [None if t is None else t.contiguous()
           for t in (q, k, v, i, f, c_initial, n_initial, m_initial)]
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ins):
        h, c, n, m = _ChunkwiseExp.apply(*ins, chunk_size, qk_scale, eps, compute_dtype)
    else:
        h, *_, (c, n, m) = chunkwise_exp_fw(*ins, chunk_size=chunk_size, qk_scale=qk_scale,
                                            eps=eps, compute_dtype=compute_dtype,
                                            save_states=False)
    return (h, (c, n, m)) if return_last_states else h
