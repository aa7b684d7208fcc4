"""Chunkwise siging mLSTM in the (B, NH, S, DH) layout, the v1 route: the
CUDA kernels, their wrappers, their plain PyTorch versions and the
autograd Function.

Counterpart of ``xlstm_yolo_tpu/ops/pallas/chunkwise.py``:

- :func:`chunkwise_fw` — the forward ``_fw``: h, the denominator of each
  row, the state before each chunk and the last state (``_fw_kernel``),
  kernel ``chunkwise_v1_fw`` in ``csrc/chunkwise_v1_fw.cu``;
- :func:`chunkwise_bw_dc` — the reverse scan of the dC states
  (``_bw_dc_kernel``), kernel ``chunkwise_v1_bw_dc`` in
  ``csrc/chunkwise_v1_bw.cu``;
- :func:`chunkwise_bw_dqkv` — dq, dk, dv per chunk from the saved C and
  dC states (``_bw_dqkv_kernel``), kernel ``chunkwise_v1_bw_dqkv`` in the
  same file;
- :func:`chunkwise_bw` — ``_bw``: both backward kernels and the gate
  gradients;
- :func:`mlstm_siging_chunkwise_v1` — ``mlstm_siging_chunkwise_pallas``,
  the differentiable function (``_chunkwise_core`` with ``_core_fwd`` and
  ``_core_bwd``); its gradient holds the max(|.|, 1) denominator constant.

The chunk length L is the caller's (S must be a multiple of it), and it is
part of the function: the products round their operands to
``compute_dtype`` (bfloat16 by default, as the JAX entry's default) and
sum in float32, per chunk, at the points where ``_fw_kernel``,
``_bw_dc_kernel`` and ``_bw_dqkv_kernel`` cast.  The row sums of the
denominator stay unrounded.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
``*_plain`` version for CPU tensors.  ``LAUNCHES_FW``, ``LAUNCHES_BW_DC``
and ``LAUNCHES_BW_DQKV`` count kernel calls (the forward's two passes and
the dC scan's two, the increments and the combine, each counted once).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xlstm_yolo_tpu_torch.ops import cuda_build
from xlstm_yolo_tpu_torch.ops.cuda_build import F as CF
from xlstm_yolo_tpu_torch.ops.cuda_build import HEAD_DIMS, I, P
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = [
    "LAUNCHES_BW_DC",
    "LAUNCHES_BW_DQKV",
    "LAUNCHES_FW",
    "chunkwise_bw",
    "chunkwise_bw_dc",
    "chunkwise_bw_dc_plain",
    "chunkwise_bw_dqkv",
    "chunkwise_bw_dqkv_plain",
    "chunkwise_fw",
    "chunkwise_fw_plain",
    "gate_grad_terms",
    "mlstm_siging_chunkwise_v1",
]

LAUNCHES_FW = 0       # launches of the forward kernel
LAUNCHES_BW_DC = 0    # calls of the dC scan (two kernels a call)
LAUNCHES_BW_DQKV = 0  # launches of the dq/dk/dv kernel

CHUNK_SIZES = (16, 32, 64, 128, 256, 512)  # the kernels' chunk lengths
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _declare_fw(lib):
    lib.chunkwise_v1_fw.argtypes = [P] * 13 + [I] * 7 + [CF, CF, P]
    lib.chunkwise_v1_fw.restype = I


def _declare_bw(lib):
    lib.chunkwise_v1_bw_dc.argtypes = [P] * 8 + [I] * 7 + [CF, CF, P]
    lib.chunkwise_v1_bw_dqkv.argtypes = [P] * 12 + [I] * 7 + [CF, CF, P]
    lib.chunkwise_v1_bw_dc.restype = lib.chunkwise_v1_bw_dqkv.restype = I


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def _check(q, k, v, i, f, chunk_size: int, compute_dtype, c_initial=None, n_initial=None):
    """Raise unless the inputs are (B, NH, S, DH) streams, (B, NH, S) gates
    and states of the accumulation type, S a multiple of the chunk."""
    if q.ndim != 4:
        raise ValueError(f"q must be (B, NH, S, DH), got {tuple(q.shape)}")
    B, NH, S, DH = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} {t.dtype} vs "
                             f"{tuple(q.shape)} {q.dtype}")
    acc = acc_dtype(q.dtype)
    for name, t in (("i", i), ("f", f)):
        if t.shape != (B, NH, S) or t.dtype != acc:
            raise ValueError(f"{name} must be {acc} {(B, NH, S)}, got {tuple(t.shape)} {t.dtype}")
    if S == 0 or chunk_size <= 0 or S % chunk_size:
        raise ValueError(f"S={S} must be a positive multiple of chunk_size={chunk_size}")
    if compute_dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise TypeError(f"compute_dtype {compute_dtype} not supported")
    if (c_initial is None) != (n_initial is None):
        raise ValueError("give both c_initial and n_initial or neither")
    if c_initial is not None:
        if c_initial.shape != (B, NH, DH, DH) or c_initial.dtype != acc:
            raise ValueError(f"c_initial must be {acc} {(B, NH, DH, DH)}")
        if n_initial.shape != (B, NH, DH) or n_initial.dtype != acc:
            raise ValueError(f"n_initial must be {acc} {(B, NH, DH)}")
    for t in (k, v, i, f, c_initial, n_initial):
        if t is not None and t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
    return B, NH, S, DH


def _check_saved(q, chunk_size, **saved):
    """Shapes of the saved and upstream tensors of the backward."""
    B, NH, S, DH = q.shape
    NC = S // chunk_size
    acc = acc_dtype(q.dtype)
    want = {"den": (B, NH, S), "c_states": (B, NH, NC, DH, DH),
            "dc_states": (B, NH, NC, DH, DH), "dc_last": (B, NH, DH, DH),
            "m_comb": (B, NH, S), "m_states": (B, NH, NC), "m_last": (B, NH),
            "mrow": (B, NH, NC, 2)}
    for name, t in saved.items():
        if name == "dh":
            if t.shape != q.shape or t.dtype != q.dtype:
                raise ValueError(f"dh must be {q.dtype} {tuple(q.shape)}")
        elif t is not None and (t.shape != want[name] or t.dtype != acc):
            raise ValueError(f"{name} must be {acc} {want[name]}, got {tuple(t.shape)} {t.dtype}")
        if t is not None and t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")


def _check_cuda(q, chunk_size, compute_dtype, tensors):
    """Raise unless the kernels take these inputs."""
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not supported by the kernel {HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES or compute_dtype not in _DTYPE_CODES:
        raise TypeError(f"q/k/v dtype {q.dtype} and compute dtype {compute_dtype} must be "
                        "float32 or bfloat16 for the kernel")
    if chunk_size not in CHUNK_SIZES:
        raise ValueError(f"chunk size {chunk_size} not supported by the kernel {CHUNK_SIZES}")
    cuda_build.check_kernel_inputs(*tensors)


def _codes(q, compute_dtype):
    return _DTYPE_CODES[q.dtype], _DTYPE_CODES[compute_dtype]


# ---------------------------------------------------------------------------
# plain versions: the JAX kernels' arithmetic, chunks as a batch dimension
# ---------------------------------------------------------------------------


def _gates(i, f, L):
    """Per-chunk gate rows (B, NH, NC, L): b = cumsum logsig(f), a =
    (g - b) + logsig(i), logsig(i); and g = b[..., -1] (B, NH, NC)."""
    B, NH, S = f.shape
    logf = F.logsigmoid(f).reshape(B, NH, S // L, L)
    logi = F.logsigmoid(i).reshape(B, NH, S // L, L)
    b = torch.cumsum(logf, dim=-1)
    g = b[..., -1]
    return b, (g[..., None] - b) + logi, logi, g


def _exp_f32(x):
    """e^x, to float32 accuracy on every call.

    On the CPU, PyTorch hands a large float32 ``exp`` to MKL's vector math
    in slices, one a thread; in the first such call of a process one
    thread's slice comes back about 1.5e-4 off (relative), whatever the
    values (-inf entries or not), and a single thread never shows it.  A
    float64 ``exp`` has the same fault at ~3e-9, which rounding to float32
    removes, so float32 CPU tensors take that route."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.exp(x.double()).float()
    return torch.exp(x)


def _decay(b, logi):
    """D = tril(e^{b_l - b_j + logsig(i_j)}), the exponent masked before exp."""
    L = b.shape[-1]
    causal = torch.ones(L, L, dtype=torch.bool, device=b.device).tril()
    logD = b[..., :, None] - b[..., None, :] + logi[..., None, :]
    return _exp_f32(torch.where(causal, logD, torch.full((), -torch.inf, dtype=b.dtype,
                                                        device=b.device)))


def _rounder(compute_dtype, acc):
    return lambda x: x.to(compute_dtype).to(acc)


def _chunks(x, L):
    B, NH, S, D = x.shape
    return x.reshape(B, NH, S // L, L, D)


def chunkwise_fw_plain(q, k, v, i, f, c_initial=None, n_initial=None, chunk_size: int = 128,
                       qk_scale: float | None = None, eps: float = 1e-6,
                       compute_dtype=torch.bfloat16):
    """Plain version of :func:`chunkwise_fw`, on any device (float64 too)."""
    B, NH, S, DH = _check(q, k, v, i, f, chunk_size, compute_dtype, c_initial, n_initial)
    L, NC = chunk_size, S // chunk_size
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    acc = acc_dtype(q.dtype)
    R = _rounder(compute_dtype, acc)
    qc, kc, vc = (_chunks(x.to(acc), L) for x in (q, k, v))
    b, a, logi, g = _gates(i, f, L)
    sd = (R(qc) @ R(kc).transpose(-1, -2)) * scale * _decay(b, logi)
    h_intra = R(sd) @ R(vc)
    n_intra = sd.sum(-1)
    kbar = kc * torch.exp(a)[..., None]
    dC = R(kbar).transpose(-1, -2) @ R(vc)
    dn = kbar.sum(-2)
    C = c_initial.to(acc) if c_initial is not None else q.new_zeros(B, NH, DH, DH, dtype=acc)
    n = n_initial.to(acc) if n_initial is not None else q.new_zeros(B, NH, DH, dtype=acc)
    gbar = torch.exp(g)
    c_states, n_states = [], []
    for c in range(NC):  # the state before each chunk
        c_states.append(C)
        n_states.append(n)
        C = gbar[..., c, None, None] * C + dC[:, :, c]
        n = gbar[..., c, None] * n + dn[:, :, c]
    c_states = torch.stack(c_states, dim=2)
    n_states = torch.stack(n_states, dim=2)
    qbar = qc * torch.exp(b)[..., None] * scale
    h_inter = R(qbar) @ R(c_states)
    n_inter = (qbar * n_states[..., None, :]).sum(-1)
    den = torch.clamp((n_inter + n_intra).abs(), min=1.0)
    h = (h_inter + h_intra) / (den[..., None] + eps)
    return (h.reshape(B, NH, S, DH).to(q.dtype), den.reshape(B, NH, S), c_states, n_states,
            C, n)


def chunkwise_bw_dc_plain(q, f, dh, den, dc_last=None, chunk_size: int = 128,
                          qk_scale: float | None = None, eps: float = 1e-6,
                          compute_dtype=torch.bfloat16):
    """Plain version of :func:`chunkwise_bw_dc`."""
    B, NH, S, DH = q.shape
    _check_saved(q, chunk_size, dh=dh, den=den, dc_last=dc_last)
    L, NC = chunk_size, S // chunk_size
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    acc = acc_dtype(q.dtype)
    R = _rounder(compute_dtype, acc)
    b, _, _, g = _gates(torch.zeros_like(f), f, L)
    qbar = _chunks(q.to(acc), L) * torch.exp(b)[..., None] * scale
    dhn = _chunks(dh.to(acc), L) / (den.reshape(B, NH, NC, L, 1) + eps)
    inc = R(qbar).transpose(-1, -2) @ R(dhn)  # (B, NH, NC, DH, DH)
    gbar = torch.exp(g)
    dC = dc_last.to(acc) if dc_last is not None else q.new_zeros(B, NH, DH, DH, dtype=acc)
    dc_states = [None] * NC
    for c in range(NC - 1, -1, -1):  # the gradient of the state after each chunk
        dc_states[c] = dC
        dC = gbar[..., c, None, None] * dC + inc[:, :, c]
    return torch.stack(dc_states, dim=2), dC


def chunkwise_bw_dqkv_plain(q, k, v, i, f, c_states, den, dh, dc_states, chunk_size: int = 128,
                            qk_scale: float | None = None, eps: float = 1e-6,
                            compute_dtype=torch.bfloat16):
    """Plain version of :func:`chunkwise_bw_dqkv`."""
    B, NH, S, DH = _check(q, k, v, i, f, chunk_size, compute_dtype)
    _check_saved(q, chunk_size, c_states=c_states, den=den, dh=dh, dc_states=dc_states)
    L, NC = chunk_size, S // chunk_size
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    acc = acc_dtype(q.dtype)
    R = _rounder(compute_dtype, acc)
    qc, kc, vc = (_chunks(x.to(acc), L) for x in (q, k, v))
    b, a, logi, _ = _gates(i, f, L)
    D = _decay(b, logi)
    dhn = _chunks(dh.to(acc), L) / (den.reshape(B, NH, NC, L, 1) + eps)
    P = (R(dhn) @ R(vc).transpose(-1, -2)) * D
    sd = (R(qc) @ R(kc).transpose(-1, -2)) * scale * D
    expb, expa = torch.exp(b)[..., None], torch.exp(a)[..., None]
    dq = (R(P) @ R(kc)) * scale + (R(dhn) @ R(c_states).transpose(-1, -2)) * (expb * scale)
    dk = (R(P).transpose(-1, -2) @ R(qc)) * scale \
        + (R(vc) @ R(dc_states).transpose(-1, -2)) * expa
    dv = R(sd).transpose(-1, -2) @ R(dhn) + R(kc * expa) @ R(dc_states)
    return tuple(x.reshape(B, NH, S, DH) for x in (dq, dk, dv))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def chunkwise_fw(q, k, v, i, f, c_initial=None, n_initial=None, chunk_size: int = 128,
                 qk_scale: float | None = None, eps: float = 1e-6, compute_dtype=torch.bfloat16):
    """The v1 forward.

    q, k, v: (B, NH, S, DH) float32 or bfloat16; i, f: (B, NH, S) float32
    pre-activations; optional c_initial (B, NH, DH, DH) and n_initial
    (B, NH, DH) float32; S a multiple of ``chunk_size``.  Returns h in q's
    dtype and, in float32, the denominator max(|.|, 1) of each row
    (B, NH, S), the state before each chunk, c_states (B, NH, NC, DH, DH)
    and n_states (B, NH, NC, DH), and the last states.

    CUDA tensors go through the hand-written kernel (or this raises); CPU
    tensors go through the plain version.
    """
    global LAUNCHES_FW
    if q.device.type == "cpu":
        return chunkwise_fw_plain(q, k, v, i, f, c_initial, n_initial, chunk_size, qk_scale,
                                  eps, compute_dtype)
    B, NH, S, DH = _check(q, k, v, i, f, chunk_size, compute_dtype, c_initial, n_initial)
    _check_cuda(q, chunk_size, compute_dtype, [q, k, v, i, f, c_initial, n_initial])
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    NC = S // chunk_size
    lib = cuda_build.load("chunkwise_v1_fw", _declare_fw)
    opts = dict(dtype=torch.float32, device=q.device)
    h = torch.empty_like(q)
    den = torch.empty(B, NH, S, **opts)
    c_states = torch.empty(B, NH, NC, DH, DH, **opts)
    n_states = torch.empty(B, NH, NC, DH, **opts)
    c_last = torch.empty(B, NH, DH, DH, **opts)
    n_last = torch.empty(B, NH, DH, **opts)
    with torch.cuda.device(q.device):
        cuda_build.launch(
            lib.chunkwise_v1_fw, "chunkwise_v1_fw",
            *cuda_build.pointers(q, k, v, i, f, c_initial, n_initial, h, den, c_states,
                                 n_states, c_last, n_last),
            B, NH, S, DH, chunk_size, *_codes(q, compute_dtype), float(scale), float(eps))
    LAUNCHES_FW += 1
    return h, den, c_states, n_states, c_last, n_last


def chunkwise_bw_dc(q, f, dh, den, dc_last=None, chunk_size: int = 128,
                    qk_scale: float | None = None, eps: float = 1e-6,
                    compute_dtype=torch.bfloat16):
    """The reverse scan dC_{k-1} = e^g dC_k + qbar_k^T (dh_k / (den_k + eps)).

    Returns dc_states (B, NH, NC, DH, DH), the gradient of the state after
    each chunk (slot NC - 1 holds ``dc_last`` or zeros), and dc0
    (B, NH, DH, DH), that of the state before the first chunk; float32.
    On the card one call is two kernels, counted as one launch: every
    chunk's increment at once, then the reverse combine.
    """
    global LAUNCHES_BW_DC
    if q.device.type == "cpu":
        return chunkwise_bw_dc_plain(q, f, dh, den, dc_last, chunk_size, qk_scale, eps,
                                     compute_dtype)
    B, NH, S, DH = q.shape
    _check_saved(q, chunk_size, dh=dh, den=den, dc_last=dc_last)
    if f.shape != (B, NH, S) or f.dtype != torch.float32 or S % chunk_size:
        raise ValueError(f"f must be float32 {(B, NH, S)} and S a multiple of {chunk_size}")
    _check_cuda(q, chunk_size, compute_dtype, [q, f, dh, den, dc_last])
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    lib = cuda_build.load("chunkwise_v1_bw", _declare_bw)
    NC = S // chunk_size
    dc_states = torch.empty(B, NH, NC, DH, DH, dtype=torch.float32, device=q.device)
    dc0 = torch.empty(B, NH, DH, DH, dtype=torch.float32, device=q.device)
    gbar = torch.empty(B, NH, NC, dtype=torch.float32, device=q.device)  # e^g per chunk
    with torch.cuda.device(q.device):
        cuda_build.launch(
            lib.chunkwise_v1_bw_dc, "chunkwise_v1_bw_dc",
            *cuda_build.pointers(q, f, dh, den, dc_last, dc_states, dc0, gbar),
            B, NH, S, DH, chunk_size, *_codes(q, compute_dtype), float(scale), float(eps))
    LAUNCHES_BW_DC += 1
    return dc_states, dc0


def chunkwise_bw_dqkv(q, k, v, i, f, c_states, den, dh, dc_states, chunk_size: int = 128,
                      qk_scale: float | None = None, eps: float = 1e-6,
                      compute_dtype=torch.bfloat16):
    """dq, dk, dv (B, NH, S, DH) float32 of every chunk, independently,
    from the saved state before the chunk and the gradient of the state
    after it: with dhn = dh / (den + eps), P = (dhn v^T) * D,

        dq = scale (P k + e^b dhn C_prev^T),
        dk = scale P^T q + e^a (v dC^T),   dv = (S * D)^T dhn + (e^a k) dC.
    """
    global LAUNCHES_BW_DQKV
    if q.device.type == "cpu":
        return chunkwise_bw_dqkv_plain(q, k, v, i, f, c_states, den, dh, dc_states, chunk_size,
                                       qk_scale, eps, compute_dtype)
    B, NH, S, DH = _check(q, k, v, i, f, chunk_size, compute_dtype)
    _check_saved(q, chunk_size, c_states=c_states, den=den, dh=dh, dc_states=dc_states)
    _check_cuda(q, chunk_size, compute_dtype, [q, k, v, i, f, c_states, den, dh, dc_states])
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    lib = cuda_build.load("chunkwise_v1_bw", _declare_bw)
    dq, dk, dv = (torch.empty(q.shape, dtype=torch.float32, device=q.device) for _ in range(3))
    with torch.cuda.device(q.device):
        cuda_build.launch(
            lib.chunkwise_v1_bw_dqkv, "chunkwise_v1_bw_dqkv",
            *cuda_build.pointers(q, k, v, i, f, c_states, den, dh, dc_states, dq, dk, dv),
            B, NH, S, DH, chunk_size, *_codes(q, compute_dtype), float(scale), float(eps))
    LAUNCHES_BW_DQKV += 1
    return dq, dk, dv


def chunkwise_bw(q, k, v, i, f, den, c_states, dh, dc_last=None, chunk_size: int = 128,
                 qk_scale: float | None = None, eps: float = 1e-6, compute_dtype=torch.bfloat16):
    """``_bw``: the dC scan, dq/dk/dv, and the gate gradients from the
    float32 dq and dk (df = revcumsum(q.dq - k.dk) sigmoid(-f), di =
    k.dk sigmoid(-i)).  Returns dq, dk, dv in q's dtype, di, df and dc0."""
    kw = dict(chunk_size=chunk_size, qk_scale=qk_scale, eps=eps, compute_dtype=compute_dtype)
    dc_states, dc0 = chunkwise_bw_dc(q, f, dh, den, dc_last, **kw)
    dq, dk, dv = chunkwise_bw_dqkv(q, k, v, i, f, c_states, den, dh, dc_states, **kw)
    kdk, df = gate_grad_terms(q, k, dq, dk, f)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), kdk * torch.sigmoid(-i), df, dc0


def gate_grad_terms(q, k, dq, dk, f):
    """The gate-gradient terms of the chunkwise and quadratic VJPs, from dq
    and dk as their kernels return them, in the accumulation type: k.dk of
    each row, and df = revcumsum(q.dq - k.dk) sigmoid(-f)."""
    acc = acc_dtype(q.dtype)
    kdk = (k.to(acc) * dk.to(acc)).sum(-1)
    dfbar = (q.to(acc) * dq.to(acc)).sum(-1) - kdk
    return kdk, dfbar.flip(-1).cumsum(-1).flip(-1) * torch.sigmoid(-f)


class _ChunkwiseV1(torch.autograd.Function):
    """``_chunkwise_core`` with ``_core_fwd`` / ``_core_bwd``: the gradient
    of c_initial is dc0 and that of n_initial zeros when initial states
    were given; the gradient of n_last is dropped, as in the JAX VJP."""

    @staticmethod
    def forward(ctx, q, k, v, i, f, c_initial, n_initial, chunk_size, qk_scale, eps,
                compute_dtype):
        h, den, c_states, _, c_last, n_last = chunkwise_fw(
            q, k, v, i, f, c_initial, n_initial, chunk_size, qk_scale, eps, compute_dtype)
        ctx.save_for_backward(q, k, v, i, f, den, c_states)
        ctx.kw = dict(chunk_size=chunk_size, qk_scale=qk_scale, eps=eps,
                      compute_dtype=compute_dtype)
        ctx.n_initial_shape = None if n_initial is None else n_initial.shape
        ctx.mark_non_differentiable(n_last)
        ctx.set_materialize_grads(False)
        return h, c_last, n_last

    @staticmethod
    def backward(ctx, dh, dc_last, _dn_last):
        q, k, v, i, f, den, c_states = ctx.saved_tensors
        dh = torch.zeros_like(q) if dh is None else dh.contiguous()
        dc_last = None if dc_last is None else dc_last.contiguous()
        dq, dk, dv, di, df, dc0 = chunkwise_bw(q, k, v, i, f, den, c_states, dh, dc_last,
                                               **ctx.kw)
        had_init = ctx.n_initial_shape is not None
        dni = dc0.new_zeros(ctx.n_initial_shape) if had_init else None
        return dq, dk, dv, di, df, dc0 if had_init else None, dni, None, None, None, None


def mlstm_siging_chunkwise_v1(q, k, v, i, f, chunk_size: int = 128, c_initial=None,
                              n_initial=None, qk_scale: float | None = None,
                              normalize: bool = True, return_last_states: bool = False,
                              eps: float = 1e-6, compute_dtype=torch.bfloat16):
    """The registry's ``chunkwise--pallas_xl_chunk_siging``: the v1 forward
    kernel, and in the backward the dC-scan and dq/dk/dv kernels (plain
    versions on CPU tensors).  (B, NH, S, DH) streams, (B, NH, S) gates, S
    a multiple of ``chunk_size``; returns h, and (c_last, n_last) with
    ``return_last_states``.  Views (the inference wrapper's segments) are
    copied to contiguous tensors for the kernels."""
    if not normalize:
        raise NotImplementedError("the unnormalized variant is not implemented, as in the JAX "
                                  "package's kernel")
    h, c_last, n_last = _ChunkwiseV1.apply(
        *(t.contiguous() for t in (q, k, v, i, f)), c_initial, n_initial, chunk_size, qk_scale,
        eps, compute_dtype)
    return (h, (c_last, n_last)) if return_last_states else h
