"""Quadratic (parallel) siging mLSTM in the (B, NH, S, DH) layout: the CUDA
kernels, their wrappers, their plain PyTorch versions and the autograd
Function.

Counterpart of ``xlstm_yolo_tpu/ops/pallas/parallel.py``, the registry's
``parallel--pallas_limit_headdim``:

- :func:`parallel_fw` — the forward ``_fw``: h and the denominator of each
  row (``_fw_kernel``), kernel ``parallel_fw`` in ``csrc/parallel_fw.cu``;
- :func:`parallel_bw_dq` — dq over query tiles (``_bw_dq_kernel``), kernel
  ``parallel_bw_dq`` in ``csrc/parallel_bw.cu``;
- :func:`parallel_bw_dkv` — dk and dv over key tiles (``_bw_dkv_kernel``),
  kernel ``parallel_bw_dkv`` in the same file;
- :func:`parallel_bw` — ``_core_bwd``: both backward kernels and the gate
  gradients;
- :func:`mlstm_siging_parallel_kernel` — ``mlstm_siging_parallel_pallas``,
  the differentiable function (``_core`` with ``_core_fwd`` and
  ``_core_bwd``); its gradient holds the max(|.|, 1) denominator constant.

The arithmetic is the Pallas kernels', not the oracle's
(``ops/mlstm_parallel.py``): b = cumsum(logsig(f)) inclusive, log D[l, j] =
(b_l - b_j) + logsig(i_j) from the cumsum difference, masked above the
diagonal before exp; the operands of every product rounded to
``compute_dtype`` (bfloat16 by default, as the JAX entry's default, in a
float32 model too) and summed in float32; the denominator's row sums
unrounded; h, dq, dk and dv written in the inputs' dtype.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
``*_plain`` version for CPU tensors.  ``LAUNCHES_FW``, ``LAUNCHES_BW_DQ``
and ``LAUNCHES_BW_DKV`` count kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xlstm_yolo_tpu_torch.ops import cuda_build
from xlstm_yolo_tpu_torch.ops.chunkwise import _decay, _rounder, gate_grad_terms
from xlstm_yolo_tpu_torch.ops.cuda_build import F as CF
from xlstm_yolo_tpu_torch.ops.cuda_build import HEAD_DIMS, I, P
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = [
    "LAUNCHES_BW_DKV",
    "LAUNCHES_BW_DQ",
    "LAUNCHES_FW",
    "gate_rows",
    "mlstm_siging_parallel_kernel",
    "parallel_bw",
    "parallel_bw_dkv",
    "parallel_bw_dkv_plain",
    "parallel_bw_dq",
    "parallel_bw_dq_plain",
    "parallel_fw",
    "parallel_fw_plain",
]

LAUNCHES_FW = 0      # launches of the forward kernel
LAUNCHES_BW_DQ = 0   # launches of the dq kernel
LAUNCHES_BW_DKV = 0  # launches of the dk/dv kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _declare_fw(lib):
    lib.parallel_fw.argtypes = [P] * 7 + [I] * 5 + [CF, CF, P]
    lib.parallel_fw.restype = I


def _declare_bw(lib):
    lib.parallel_bw_dq.argtypes = [P] * 7 + [I] * 5 + [CF, CF, P]
    lib.parallel_bw_dkv.argtypes = [P] * 9 + [I] * 5 + [CF, CF, P]
    lib.parallel_bw_dq.restype = lib.parallel_bw_dkv.restype = I


def _check(q, k, v, i, f, compute_dtype, den=None, dh=None):
    """Raise unless the inputs are (B, NH, S, DH) streams of one dtype,
    (B, NH, S) gates (and den) of the accumulation type and dh like q."""
    if q.ndim != 4:
        raise ValueError(f"q must be (B, NH, S, DH), got {tuple(q.shape)}")
    B, NH, S, DH = q.shape
    for name, t in (("k", k), ("v", v), ("dh", dh)):
        if t is not None and (t.shape != q.shape or t.dtype != q.dtype):
            raise ValueError(f"{name} must match q: {tuple(t.shape)} {t.dtype} vs "
                             f"{tuple(q.shape)} {q.dtype}")
    acc = acc_dtype(q.dtype)
    for name, t in (("i", i), ("f", f), ("den", den)):
        if t is not None and (t.shape != (B, NH, S) or t.dtype != acc):
            raise ValueError(f"{name} must be {acc} {(B, NH, S)}, got {tuple(t.shape)} {t.dtype}")
    if S == 0:
        raise ValueError("empty sequence")
    if compute_dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise TypeError(f"compute_dtype {compute_dtype} not supported")
    for t in (k, v, i, f, den, dh):
        if t is not None and t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
    return B, NH, S, DH


def _check_cuda(q, compute_dtype, tensors):
    """Raise unless the kernels take these inputs."""
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not supported by the kernel {HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES or compute_dtype not in _DTYPE_CODES:
        raise TypeError(f"q/k/v dtype {q.dtype} and compute dtype {compute_dtype} must be "
                        "float32 or bfloat16 for the kernel")
    cuda_build.check_kernel_inputs(*tensors)


def _launch_args(q, compute_dtype, qk_scale, eps):
    B, NH, S, DH = q.shape
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    return (B * NH, S, DH, _DTYPE_CODES[q.dtype], _DTYPE_CODES[compute_dtype], float(scale),
            float(eps))


def gate_rows(i, f):
    """The gate rows of the kernels, (B, NH, S) each: b = cumsum(logsig(f))
    inclusive and logsig(i), as the JAX entry computes them outside its
    kernels."""
    return torch.cumsum(F.logsigmoid(f), dim=-1), F.logsigmoid(i)


# ---------------------------------------------------------------------------
# plain versions: the Pallas kernels' arithmetic on whole (S, S) matrices,
# D from the v1 route's _decay (the same expression over one whole chunk)
# ---------------------------------------------------------------------------


def _scale(q, qk_scale):
    return q.shape[-1] ** -0.5 if qk_scale is None else qk_scale


def parallel_fw_plain(q, k, v, i, f, qk_scale: float | None = None, eps: float = 1e-6,
                      compute_dtype=torch.bfloat16):
    """Plain version of :func:`parallel_fw`, on any device (float64 too)."""
    _check(q, k, v, i, f, compute_dtype)
    acc = acc_dtype(q.dtype)
    R = _rounder(compute_dtype, acc)
    D = _decay(*gate_rows(i, f))
    sd = (R(q) @ R(k).transpose(-1, -2)) * _scale(q, qk_scale) * D
    num = R(sd) @ R(v)
    den = torch.clamp(sd.sum(-1).abs(), min=1.0)
    return (num / (den[..., None] + eps)).to(q.dtype), den


def parallel_bw_dq_plain(q, k, v, i, f, den, dh, qk_scale: float | None = None,
                         eps: float = 1e-6, compute_dtype=torch.bfloat16):
    """Plain version of :func:`parallel_bw_dq`."""
    _check(q, k, v, i, f, compute_dtype, den, dh)
    acc = acc_dtype(q.dtype)
    R = _rounder(compute_dtype, acc)
    D = _decay(*gate_rows(i, f))
    dhn = dh.to(acc) / (den[..., None] + eps)
    p = (R(dhn) @ R(v).transpose(-1, -2)) * D
    return ((R(p) @ R(k)) * _scale(q, qk_scale)).to(q.dtype)


def parallel_bw_dkv_plain(q, k, v, i, f, den, dh, qk_scale: float | None = None,
                          eps: float = 1e-6, compute_dtype=torch.bfloat16):
    """Plain version of :func:`parallel_bw_dkv`: in the key-major
    arrangement of ``_bw_dkv_kernel``."""
    _check(q, k, v, i, f, compute_dtype, den, dh)
    acc = acc_dtype(q.dtype)
    R = _rounder(compute_dtype, acc)
    scale = _scale(q, qk_scale)
    dt = _decay(*gate_rows(i, f)).transpose(-1, -2)  # D^T[j, l]
    dhn = dh.to(acc) / (den[..., None] + eps)
    pt = (R(v) @ R(dhn).transpose(-1, -2)) * dt
    dk = (R(pt) @ R(q)) * scale
    sdt = (R(k) @ R(q).transpose(-1, -2)) * scale * dt
    dv = R(sdt) @ R(dhn)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def parallel_fw(q, k, v, i, f, qk_scale: float | None = None, eps: float = 1e-6,
                compute_dtype=torch.bfloat16):
    """The quadratic forward.

    q, k, v: (B, NH, S, DH) float32 or bfloat16; i, f: (B, NH, S) float32
    pre-activations.  Returns h in q's dtype and the denominator
    max(|.|, 1) of each row (B, NH, S) float32, which the backward takes.

    CUDA tensors go through the hand-written kernel (or this raises); CPU
    tensors go through the plain version.
    """
    global LAUNCHES_FW
    if q.device.type == "cpu":
        return parallel_fw_plain(q, k, v, i, f, qk_scale, eps, compute_dtype)
    B, NH, S, DH = _check(q, k, v, i, f, compute_dtype)
    _check_cuda(q, compute_dtype, [q, k, v, i, f])
    b, li = gate_rows(i, f)
    lib = cuda_build.load("parallel_fw", _declare_fw)
    h = torch.empty_like(q)
    den = torch.empty(B, NH, S, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        cuda_build.launch(lib.parallel_fw, "parallel_fw",
                          *cuda_build.pointers(q, k, v, b, li, h, den),
                          *_launch_args(q, compute_dtype, qk_scale, eps))
    LAUNCHES_FW += 1
    return h, den


def parallel_bw_dq(q, k, v, i, f, den, dh, qk_scale: float | None = None, eps: float = 1e-6,
                   compute_dtype=torch.bfloat16):
    """dq (B, NH, S, DH) in q's dtype: with dhn = dh / (den + eps) and
    P = (dhn v^T) * D, dq = scale P k."""
    global LAUNCHES_BW_DQ
    if q.device.type == "cpu":
        return parallel_bw_dq_plain(q, k, v, i, f, den, dh, qk_scale, eps, compute_dtype)
    _check(q, k, v, i, f, compute_dtype, den, dh)
    _check_cuda(q, compute_dtype, [k, v, i, f, den, dh])
    b, li = gate_rows(i, f)
    lib = cuda_build.load("parallel_bw", _declare_bw)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        cuda_build.launch(lib.parallel_bw_dq, "parallel_bw_dq",
                          *cuda_build.pointers(k, v, b, li, den, dh, dq),
                          *_launch_args(q, compute_dtype, qk_scale, eps))
    LAUNCHES_BW_DQ += 1
    return dq


def parallel_bw_dkv(q, k, v, i, f, den, dh, qk_scale: float | None = None, eps: float = 1e-6,
                    compute_dtype=torch.bfloat16):
    """dk, dv (B, NH, S, DH) in k's and v's dtype: dk = scale P^T q and
    dv = (S * D)^T dhn, with P as in :func:`parallel_bw_dq`."""
    global LAUNCHES_BW_DKV
    if q.device.type == "cpu":
        return parallel_bw_dkv_plain(q, k, v, i, f, den, dh, qk_scale, eps, compute_dtype)
    _check(q, k, v, i, f, compute_dtype, den, dh)
    _check_cuda(q, compute_dtype, [q, k, v, i, f, den, dh])
    b, li = gate_rows(i, f)
    lib = cuda_build.load("parallel_bw", _declare_bw)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        cuda_build.launch(lib.parallel_bw_dkv, "parallel_bw_dkv",
                          *cuda_build.pointers(q, k, v, b, li, den, dh, dk, dv),
                          *_launch_args(q, compute_dtype, qk_scale, eps))
    LAUNCHES_BW_DKV += 1
    return dk, dv


def parallel_bw(q, k, v, i, f, den, dh, qk_scale: float | None = None, eps: float = 1e-6,
                compute_dtype=torch.bfloat16):
    """``_core_bwd``: dq, dk, dv from the two kernels, and the gate gradients
    in float32 from the rounded dq and dk, df = revcumsum(q.dq - k.dk)
    sigmoid(-f), di = k.dk sigmoid(-i).  Returns dq, dk, dv, di, df."""
    kw = dict(qk_scale=qk_scale, eps=eps, compute_dtype=compute_dtype)
    dq = parallel_bw_dq(q, k, v, i, f, den, dh, **kw)
    dk, dv = parallel_bw_dkv(q, k, v, i, f, den, dh, **kw)
    kdk, df = gate_grad_terms(q, k, dq, dk, f)
    return dq, dk, dv, kdk * torch.sigmoid(-i), df


class _Parallel(torch.autograd.Function):
    """``_core`` with ``_core_fwd`` / ``_core_bwd``: saves q, k, v, i, f and
    the denominator."""

    @staticmethod
    def forward(ctx, q, k, v, i, f, qk_scale, eps, compute_dtype):
        h, den = parallel_fw(q, k, v, i, f, qk_scale, eps, compute_dtype)
        ctx.save_for_backward(q, k, v, i, f, den)
        ctx.kw = dict(qk_scale=qk_scale, eps=eps, compute_dtype=compute_dtype)
        return h

    @staticmethod
    def backward(ctx, dh):
        q, k, v, i, f, den = ctx.saved_tensors
        dq, dk, dv, di, df = parallel_bw(q, k, v, i, f, den, dh.contiguous(), **ctx.kw)
        return dq, dk, dv, di, df, None, None, None


def mlstm_siging_parallel_kernel(q, k, v, i, f, qk_scale: float | None = None,
                                 normalize: bool = True, eps: float = 1e-6,
                                 compute_dtype=torch.bfloat16, **_ignored):
    """The registry's ``parallel--pallas_limit_headdim``: the quadratic
    forward kernel, and in the backward the dq and dk/dv kernels (plain
    versions on CPU tensors).  (B, NH, S, DH) streams, (B, NH, S) gates, any
    S; returns h only.  Other keywords (a chunk size, initial states) are
    ignored, as the JAX entry ignores them."""
    if not normalize:
        raise NotImplementedError("the unnormalized variant is not implemented, as in the JAX "
                                  "package's kernel")
    return _Parallel.apply(*(t.contiguous() for t in (q, k, v, i, f)), qk_scale, eps,
                           compute_dtype)
