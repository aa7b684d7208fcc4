"""Chunkwise siging mLSTM in the (B, S, H) layout: the CUDA kernels, their
wrappers, their plain PyTorch versions and the autograd Function.

Counterpart of ``xlstm_yolo_tpu/ops/pallas/chunkwise_v2.py``:

- :func:`mlstm_siging_chunkwise_fw` — the inference forward
  (``_fw_kernel_infer``), kernel ``chunkwise_fw`` in ``csrc/chunkwise_fw.cu``;
- :func:`mlstm_siging_chunkwise_fw_ln` — the inference forward with the
  per-head LayerNorm fused in (``_fw_kernel_infer_ln``), kernel
  ``chunkwise_fw_ln`` in the same file; forward only;
- :func:`mlstm_siging_chunkwise_fw_train` — the forward that also saves the
  state before each chunk and the denominator per row
  (``_fw_kernel_train``), kernel ``chunkwise_fw_train`` in the same file;
- :func:`mlstm_siging_chunkwise_bw` — the backward: reverse dC scan with
  dq, dk, dv per chunk and dC0 (``_bw_fused_kernel`` and its transposed
  twin ``_bw_fused_kernel_t``), ``csrc/chunkwise_bw.cu``: two passes, the
  dC scan (:func:`mlstm_siging_chunkwise_bw_dc`) and the chunk-parallel
  dq/dk/dv (:func:`mlstm_siging_chunkwise_bw_dqkv`), their products on the
  tensor cores for bfloat16 and on the CUDA cores for float32;
- :func:`mlstm_siging_chunkwise_train` — the differentiable cell
  (``_chunkwise_core_v2`` with ``_core_fwd`` / ``_core_bwd``).  Its
  gradient holds the max(|.|, 1) denominator constant, at every S;
- :func:`mlstm_siging_chunkwise_v2_heads` — the registry's entry
  (``mlstm_siging_chunkwise_pallas_v2``) on (B, NH, S, DH) operands.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
``*_plain`` version for CPU tensors.  ``LAUNCHES``, ``LAUNCHES_LN``,
``LAUNCHES_TRAIN`` and ``LAUNCHES_BW`` count kernel launches.
"""

from __future__ import annotations

import torch

from xlstm_yolo_tpu_torch.ops import cuda_build
from xlstm_yolo_tpu_torch.ops.cuda_build import HEAD_DIMS, F, I, P
from xlstm_yolo_tpu_torch.ops.mlstm_chunkwise import mlstm_siging_chunkwise
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = [
    "LAUNCHES",
    "LAUNCHES_BW",
    "LAUNCHES_LN",
    "LAUNCHES_TRAIN",
    "gate_grads",
    "mlstm_siging_chunkwise_bw",
    "mlstm_siging_chunkwise_bw_dc",
    "mlstm_siging_chunkwise_bw_dc_plain",
    "mlstm_siging_chunkwise_bw_dqkv",
    "mlstm_siging_chunkwise_bw_dqkv_plain",
    "mlstm_siging_chunkwise_bw_plain",
    "mlstm_siging_chunkwise_fw",
    "mlstm_siging_chunkwise_fw_ln",
    "mlstm_siging_chunkwise_fw_ln_plain",
    "mlstm_siging_chunkwise_fw_plain",
    "mlstm_siging_chunkwise_fw_train",
    "mlstm_siging_chunkwise_fw_train_plain",
    "mlstm_siging_chunkwise_train",
    "mlstm_siging_chunkwise_train_plain",
    "mlstm_siging_chunkwise_v2_heads",
]

LAUNCHES = 0        # launches of the inference forward kernel
LAUNCHES_LN = 0     # launches of the inference forward with the fused LayerNorm
LAUNCHES_TRAIN = 0  # launches of the train forward kernel
LAUNCHES_BW = 0     # calls of the backward that launched its kernels

CHUNK_SIZE = 64  # the kernels' chunk length (L in csrc/chunkwise_*.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _declare_fw(lib):
    lib.chunkwise_fw.argtypes = [P] * 10 + [I] * 5 + [F, F, P]
    lib.chunkwise_fw_train.argtypes = [P] * 13 + [I] * 5 + [F, F, P]
    lib.chunkwise_fw_ln.argtypes = [P] * 12 + [I] * 5 + [F, F, F, P]
    lib.chunkwise_fw.restype = lib.chunkwise_fw_train.restype = lib.chunkwise_fw_ln.restype = I


def _declare_bw(lib):
    lib.chunkwise_bw.argtypes = [P] * 14 + [I] * 5 + [F, F, P]
    lib.chunkwise_bw_dc.argtypes = [P] * 7 + [I] * 5 + [F, F, P]
    lib.chunkwise_bw_dqkv.argtypes = [P] * 12 + [I] * 5 + [F, F, P]
    lib.chunkwise_bw.restype = lib.chunkwise_bw_dc.restype = lib.chunkwise_bw_dqkv.restype = I


def _check(q, k, v, i, f, num_heads, c_initial, n_initial):
    B, S, H = q.shape
    if S == 0 or B == 0:
        raise ValueError("empty input")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} {t.dtype} vs "
                             f"{tuple(q.shape)} {q.dtype}")
    if H % num_heads:
        raise ValueError(f"H={H} not divisible by num_heads={num_heads}")
    DH = H // num_heads
    acc = acc_dtype(q.dtype)  # gates and states: float32 (float64 for float64 q)
    for name, t in (("i", i), ("f", f)):
        if t.shape != (B, S, num_heads) or t.dtype != acc:
            raise ValueError(f"{name} must be {acc} {(B, S, num_heads)}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if (c_initial is None) != (n_initial is None):
        raise ValueError("give both c_initial and n_initial or neither")
    if c_initial is not None:
        if c_initial.shape != (B, num_heads, DH, DH) or c_initial.dtype != acc:
            raise ValueError(f"c_initial must be {acc} {(B, num_heads, DH, DH)}")
        if n_initial.shape != (B, num_heads, DH) or n_initial.dtype != acc:
            raise ValueError(f"n_initial must be {acc} {(B, num_heads, DH)}")
    tensors = [q, k, v, i, f] + ([c_initial, n_initial] if c_initial is not None else [])
    dev = q.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
    return B, S, H, DH, tensors


def _check_cuda(q, DH, tensors):
    """Raise unless the kernels take these inputs."""
    if DH not in HEAD_DIMS:
        raise ValueError(f"head dim {DH} not supported by the kernel {HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q/k/v dtype {q.dtype} not supported by the kernel "
                        "(float32 or bfloat16)")
    cuda_build.check_kernel_inputs(*tensors)


def _heads(x, NH):
    B, S, H = x.shape
    return x.reshape(B, S, NH, H // NH).transpose(1, 2)


# ---------------------------------------------------------------------------
# inference forward
# ---------------------------------------------------------------------------


def mlstm_siging_chunkwise_fw_plain(q, k, v, i, f, num_heads: int, c_initial=None,
                                    n_initial=None, eps: float = 1e-6,
                                    qk_scale: float | None = None,
                                    return_last_states: bool = False):
    """Plain PyTorch version of the kernel: same interface, any device, and
    float64 streams too (with float64 gates and states), for a reference."""
    B, S, H, DH, _ = _check(q, k, v, i, f, num_heads, c_initial, n_initial)
    h, state = mlstm_siging_chunkwise(
        _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads),
        i.transpose(1, 2), f.transpose(1, 2), chunk_size=CHUNK_SIZE,
        c_initial=c_initial, n_initial=n_initial, qk_scale=qk_scale,
        return_last_states=True, eps=eps)
    h = h.transpose(1, 2).reshape(B, S, H)
    return (h, state) if return_last_states else h


def mlstm_siging_chunkwise_fw(q, k, v, i, f, num_heads: int, c_initial=None,
                              n_initial=None, eps: float = 1e-6,
                              qk_scale: float | None = None,
                              return_last_states: bool = False):
    """Chunkwise siging mLSTM forward.

    q, k, v: (B, S, NH*DH) float32 or bfloat16; i, f: (B, S, NH) float32
    pre-activations; optional c_initial (B, NH, DH, DH) and n_initial
    (B, NH, DH) float32.  Returns h (B, S, NH*DH) in q's dtype and, with
    ``return_last_states``, (c_last, n_last) in float32.

    CUDA tensors go through the hand-written kernel (or this raises);
    CPU tensors go through the plain version.
    """
    global LAUNCHES
    if q.device.type == "cpu":
        return mlstm_siging_chunkwise_fw_plain(
            q, k, v, i, f, num_heads, c_initial, n_initial, eps=eps,
            qk_scale=qk_scale, return_last_states=return_last_states)
    B, S, H, DH, tensors = _check(q, k, v, i, f, num_heads, c_initial, n_initial)
    _check_cuda(q, DH, tensors)
    if qk_scale is None:
        qk_scale = DH ** -0.5
    lib = cuda_build.load("chunkwise_fw", _declare_fw)
    h = torch.empty_like(q)
    c_last = torch.empty(B, num_heads, DH, DH, dtype=torch.float32, device=q.device)
    n_last = torch.empty(B, num_heads, DH, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        cuda_build.launch(
            lib.chunkwise_fw, "chunkwise_fw",
            *cuda_build.pointers(q, k, v, i, f, c_initial, n_initial, h, c_last, n_last),
            B, S, num_heads, DH, _DTYPE_CODES[q.dtype], float(qk_scale), float(eps))
    LAUNCHES += 1
    return (h, (c_last, n_last)) if return_last_states else h


# ---------------------------------------------------------------------------
# inference forward with the per-head LayerNorm fused in
# ---------------------------------------------------------------------------


def _check_ln(q, ln_weight, ln_bias):
    H = q.shape[-1]
    if ln_weight is None:
        raise ValueError("ln_weight is required (the caller's 1 + w)")
    for name, t in (("ln_weight", ln_weight), ("ln_bias", ln_bias)):
        if t is not None and (t.shape != (H,) or t.device != q.device):
            raise ValueError(f"{name} must be ({H},) on {q.device}, got {tuple(t.shape)} "
                             f"on {t.device}")


def mlstm_siging_chunkwise_fw_ln_plain(q, k, v, i, f, num_heads: int, ln_weight, ln_bias=None,
                                       c_initial=None, n_initial=None, eps: float = 1e-6,
                                       qk_scale: float | None = None, ln_eps: float = 1e-6,
                                       return_last_states: bool = False):
    """Plain version of :func:`mlstm_siging_chunkwise_fw_ln`: the plain
    inference forward in float32 (float64 for float64 q), the per-head
    LayerNorm of that h, then the cast to q's dtype."""
    B, S, H, DH, _ = _check(q, k, v, i, f, num_heads, c_initial, n_initial)
    _check_ln(q, ln_weight, ln_bias)
    acc = acc_dtype(q.dtype)
    h, state = mlstm_siging_chunkwise_fw_plain(
        q.to(acc), k.to(acc), v.to(acc), i, f, num_heads, c_initial, n_initial, eps=eps,
        qk_scale=qk_scale, return_last_states=True)
    hh = h.reshape(B, S, num_heads, DH)
    mu = hh.mean(-1, keepdim=True)
    var = (hh - mu).square().mean(-1, keepdim=True)
    y = ((hh - mu) * torch.rsqrt(var + ln_eps)).reshape(B, S, H) * ln_weight.to(acc)
    if ln_bias is not None:
        y = y + ln_bias.to(acc)
    y = y.to(q.dtype)
    return (y, state) if return_last_states else y


def mlstm_siging_chunkwise_fw_ln(q, k, v, i, f, num_heads: int, ln_weight, ln_bias=None,
                                 c_initial=None, n_initial=None, eps: float = 1e-6,
                                 qk_scale: float | None = None, ln_eps: float = 1e-6,
                                 return_last_states: bool = False):
    """The inference forward with MultiHeadLayerNorm fused in, as
    ``mlstm_siging_chunkwise_pallas_v2_bsh(..., ln_weight, ln_bias)``.

    As :func:`mlstm_siging_chunkwise_fw`, then each row's float32 h of each
    head is normalised over DH (mean, centred variance, rsqrt(var +
    ln_eps)), times ``ln_weight`` (H,) (the caller's 1 + w) plus
    ``ln_bias`` (H,) (None: 0), and cast to q's dtype.  Forward only: it
    does not take part in autograd.
    """
    global LAUNCHES_LN
    if q.device.type == "cpu":
        return mlstm_siging_chunkwise_fw_ln_plain(
            q, k, v, i, f, num_heads, ln_weight, ln_bias, c_initial, n_initial, eps=eps,
            qk_scale=qk_scale, ln_eps=ln_eps, return_last_states=return_last_states)
    B, S, H, DH, tensors = _check(q, k, v, i, f, num_heads, c_initial, n_initial)
    _check_ln(q, ln_weight, ln_bias)
    lnw = ln_weight.detach().float().contiguous()
    lnb = (torch.zeros_like(lnw) if ln_bias is None
           else ln_bias.detach().float().contiguous())
    _check_cuda(q, DH, tensors + [lnw, lnb])
    if qk_scale is None:
        qk_scale = DH ** -0.5
    lib = cuda_build.load("chunkwise_fw", _declare_fw)
    h = torch.empty_like(q)
    c_last = torch.empty(B, num_heads, DH, DH, dtype=torch.float32, device=q.device)
    n_last = torch.empty(B, num_heads, DH, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        cuda_build.launch(
            lib.chunkwise_fw_ln, "chunkwise_fw_ln",
            *cuda_build.pointers(q, k, v, i, f, c_initial, n_initial, lnw, lnb, h, c_last,
                                 n_last),
            B, S, num_heads, DH, _DTYPE_CODES[q.dtype], float(qk_scale), float(eps),
            float(ln_eps))
    LAUNCHES_LN += 1
    return (h, (c_last, n_last)) if return_last_states else h


# ---------------------------------------------------------------------------
# train forward: also the state before each chunk and the denominator
# ---------------------------------------------------------------------------


def mlstm_siging_chunkwise_fw_train_plain(q, k, v, i, f, num_heads: int, c_initial=None,
                                          n_initial=None, eps: float = 1e-6,
                                          qk_scale: float | None = None):
    """Plain version of the train forward; see
    :func:`mlstm_siging_chunkwise_fw_train`."""
    B, S, H, DH, _ = _check(q, k, v, i, f, num_heads, c_initial, n_initial)
    h, last, (c_prev, n_prev, den) = mlstm_siging_chunkwise(
        _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads),
        i.transpose(1, 2), f.transpose(1, 2), chunk_size=CHUNK_SIZE,
        c_initial=c_initial, n_initial=n_initial, qk_scale=qk_scale,
        return_last_states=True, eps=eps, return_chunk_states=True)
    h = h.transpose(1, 2).reshape(B, S, H)
    states = (c_prev.transpose(1, 2).contiguous(), n_prev.transpose(1, 2).contiguous(),
              den.transpose(1, 2).contiguous())
    return h, last, states


def mlstm_siging_chunkwise_fw_train(q, k, v, i, f, num_heads: int, c_initial=None,
                                    n_initial=None, eps: float = 1e-6,
                                    qk_scale: float | None = None):
    """The forward of training.

    Returns ``h, (c_last, n_last), (c_states, n_states, den)``: h as
    :func:`mlstm_siging_chunkwise_fw` does, and in float32 the state
    before each chunk of L = 64 rows, c_states (B, NC, NH, DH, DH) and
    n_states (B, NC, NH, DH), and the denominator max(|n . q|, 1) of each
    row, den (B, NC, NH, L) (1 on the rows past S).
    """
    global LAUNCHES_TRAIN
    if q.device.type == "cpu":
        return mlstm_siging_chunkwise_fw_train_plain(
            q, k, v, i, f, num_heads, c_initial, n_initial, eps=eps, qk_scale=qk_scale)
    B, S, H, DH, tensors = _check(q, k, v, i, f, num_heads, c_initial, n_initial)
    _check_cuda(q, DH, tensors)
    if qk_scale is None:
        qk_scale = DH ** -0.5
    NC = -(-S // CHUNK_SIZE)
    lib = cuda_build.load("chunkwise_fw", _declare_fw)
    dev = q.device
    h = torch.empty_like(q)
    c_last = torch.empty(B, num_heads, DH, DH, dtype=torch.float32, device=dev)
    n_last = torch.empty(B, num_heads, DH, dtype=torch.float32, device=dev)
    c_states = torch.empty(B, NC, num_heads, DH, DH, dtype=torch.float32, device=dev)
    n_states = torch.empty(B, NC, num_heads, DH, dtype=torch.float32, device=dev)
    den = torch.empty(B, NC, num_heads, CHUNK_SIZE, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        cuda_build.launch(
            lib.chunkwise_fw_train, "chunkwise_fw_train",
            *cuda_build.pointers(q, k, v, i, f, c_initial, n_initial, h, c_last, n_last,
                                 c_states, n_states, den),
            B, S, num_heads, DH, _DTYPE_CODES[q.dtype], float(qk_scale), float(eps))
    LAUNCHES_TRAIN += 1
    return h, (c_last, n_last), (c_states, n_states, den)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _check_bw(q, num_heads, c_states, den, dh, dc_last):
    B, S, H = q.shape
    DH = H // num_heads
    NC = -(-S // CHUNK_SIZE)
    acc = acc_dtype(q.dtype)
    if dh.shape != q.shape or dh.dtype != q.dtype or dh.device != q.device:
        raise ValueError(f"dh must be {q.dtype} {tuple(q.shape)} on {q.device}")
    if c_states is not None and (c_states.shape != (B, NC, num_heads, DH, DH)
                                 or c_states.dtype != acc):
        raise ValueError(f"c_states must be {acc} {(B, NC, num_heads, DH, DH)}")
    if den.shape != (B, NC, num_heads, CHUNK_SIZE) or den.dtype != acc:
        raise ValueError(f"den must be {acc} {(B, NC, num_heads, CHUNK_SIZE)}")
    if dc_last is not None and (dc_last.shape != (B, num_heads, DH, DH) or dc_last.dtype != acc):
        raise ValueError(f"dc_last must be {acc} {(B, num_heads, DH, DH)}")


def mlstm_siging_chunkwise_bw_plain(q, k, v, i, f, num_heads: int, c_states, den, dh,
                                    dc_last=None, eps: float = 1e-6,
                                    qk_scale: float | None = None):
    """Plain version of the backward: autograd through the plain forward
    with the saved denominator held constant (stop-grad), from the saved
    initial state ``c_states[:, 0]``."""
    _check(q, k, v, i, f, num_heads, None, None)
    _check_bw(q, num_heads, c_states, den, dh, dc_last)
    B, S, H = q.shape
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        c0 = c_states[:, 0].detach().clone().requires_grad_()
        h, (c_last, _) = mlstm_siging_chunkwise(
            _heads(qq, num_heads), _heads(kk, num_heads), _heads(vv, num_heads),
            i.detach().transpose(1, 2), f.detach().transpose(1, 2), chunk_size=CHUNK_SIZE,
            c_initial=c0, qk_scale=qk_scale, return_last_states=True, eps=eps,
            den=den.transpose(1, 2))
        outs, grads = [h.transpose(1, 2).reshape(B, S, H)], [dh]
        if dc_last is not None:
            outs.append(c_last)
            grads.append(dc_last)
        dq, dk, dv, dc0 = torch.autograd.grad(outs, [qq, kk, vv, c0], grads)
    return dq, dk, dv, dc0


def _chunked(x, NH, NC, acc):
    """(B, S, NH * DH) -> (B, NH, NC, L, DH) in ``acc``, rows past S zero."""
    B, S, H = x.shape
    x = torch.nn.functional.pad(x.to(acc), (0, 0, 0, NC * CHUNK_SIZE - S))
    return x.reshape(B, NC, CHUNK_SIZE, NH, H // NH).permute(0, 3, 1, 2, 4)


def _unchunked(x, S, dtype):
    """(B, NH, NC, L, DH) -> (B, S, NH * DH) in ``dtype``."""
    B, NH, NC, L, DH = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(B, NC * L, NH * DH)[:, :S].to(dtype)


def _chunk_gates(f, i, NC, acc):
    """b (within-chunk cumsum of logsig(f)), and with i given a = (g - b) +
    logsig(i), g = b[L - 1], and logsig(i), each (B, NH, NC, L): rows past
    S add 0 to b, logsig(i) = -inf there (inert, as JAX's padding)."""
    B, S, NH = f.shape
    pad = NC * CHUNK_SIZE - S
    lf = torch.nn.functional.pad(torch.nn.functional.logsigmoid(f.to(acc)), (0, 0, 0, pad))
    b = lf.reshape(B, NC, CHUNK_SIZE, NH).permute(0, 3, 1, 2).cumsum(-1)
    if i is None:
        return b
    li = torch.nn.functional.pad(torch.nn.functional.logsigmoid(i.to(acc)), (0, 0, 0, pad),
                                 value=-float("inf"))
    li = li.reshape(B, NC, CHUNK_SIZE, NH).permute(0, 3, 1, 2)
    return b, (b[..., -1:] - b) + li, li


def mlstm_siging_chunkwise_bw_dc_plain(q, f, num_heads: int, den, dh, dc_last=None,
                                       eps: float = 1e-6, qk_scale: float | None = None):
    """Plain version of the dC scan, the first pass of the backward: walking
    the chunks in reverse from ``dc_last`` (or 0),
    dC <- e^g dC + R(q e^b scale)^T R(dh / (den + eps)), R rounding a
    product's operand to q's dtype (JAX's ``.astype(dtype)``), sums in
    float32 (float64 for float64 q).  Returns dc_states (B, NC, NH, DH,
    DH), the gradient of the state after each chunk, in q's dtype (what
    every reader rounds it to), and dC0 in float32 (float64)."""
    B, S, H = q.shape
    NH, NC = num_heads, -(-S // CHUNK_SIZE)
    DH = H // NH
    if qk_scale is None:
        qk_scale = DH ** -0.5
    acc, cd = acc_dtype(q.dtype), q.dtype
    R = lambda x: x.to(cd).to(acc)  # noqa: E731
    b = _chunk_gates(f, None, NC, acc)
    qbar = R(_chunked(q, NH, NC, acc) * b.exp()[..., None] * qk_scale)
    dhn = R(_chunked(dh, NH, NC, acc) / (den.to(acc).transpose(1, 2)[..., None] + eps))
    dc = (torch.zeros(B, NH, DH, DH, dtype=acc, device=q.device) if dc_last is None
          else dc_last.to(acc))
    after = [None] * NC
    for c in reversed(range(NC)):
        after[c] = dc
        dc = b[:, :, c, -1, None, None].exp() * dc + qbar[:, :, c].transpose(-1, -2) @ dhn[:, :, c]
    return torch.stack(after, dim=1).to(cd), dc


def mlstm_siging_chunkwise_bw_dqkv_plain(q, k, v, i, f, num_heads: int, c_states, den, dh,
                                         dc_states, eps: float = 1e-6,
                                         qk_scale: float | None = None):
    """Plain version of the second pass of the backward: every chunk alone,
    from the state before it (``c_states``) and the gradient of the state
    after it (``dc_states``, the first pass's), R as in
    :func:`mlstm_siging_chunkwise_bw_dc_plain`:

        P  = (R(dhn) R(v)^T) * D,  SD = (R(q) R(k)^T) * scale * D
        dq = R(P) R(k) scale + e^b scale (R(dhn) R(C_prev)^T)
        dk = R(P)^T R(q) scale + e^a (R(v) R(dC)^T)
        dv = R(SD)^T R(dhn) + R(k e^a) R(dC)

    with D[l, j] = e^{b_l - b_j + logsig(i_j)} for j <= l (the exponent
    masked before exp).  Returns dq, dk, dv in q's dtype."""
    B, S, H = q.shape
    NH, NC = num_heads, -(-S // CHUNK_SIZE)
    DH = H // NH
    if qk_scale is None:
        qk_scale = DH ** -0.5
    acc, cd = acc_dtype(q.dtype), q.dtype
    R = lambda x: x.to(cd).to(acc)  # noqa: E731
    qc, kc, vc = (R(_chunked(t, NH, NC, acc)) for t in (q, k, v))
    b, a, li = _chunk_gates(f, i, NC, acc)
    dhn = R(_chunked(dh, NH, NC, acc) / (den.to(acc).transpose(1, 2)[..., None] + eps))
    causal = torch.ones(CHUNK_SIZE, CHUNK_SIZE, dtype=torch.bool, device=q.device).tril()
    logd = b[..., :, None] - b[..., None, :] + li[..., None, :]
    d = torch.where(causal, torch.where(causal, logd, -float("inf")).exp(), 0.0)
    c_prev = R(c_states.to(acc).transpose(1, 2))
    dc = R(dc_states.to(acc).transpose(1, 2))
    p = R((dhn @ vc.transpose(-1, -2)) * d)
    sd = R((qc @ kc.transpose(-1, -2)) * qk_scale * d)
    eb, ea = b.exp()[..., None], a.exp()[..., None]
    dq = (p @ kc) * qk_scale + (dhn @ c_prev.transpose(-1, -2)) * (eb * qk_scale)
    dk = (p.transpose(-1, -2) @ qc) * qk_scale + (vc @ dc.transpose(-1, -2)) * ea
    dv = sd.transpose(-1, -2) @ dhn + R(kc * ea) @ dc
    return tuple(_unchunked(x, S, cd) for x in (dq, dk, dv))


def _launch_bw(name, q, *args):
    with torch.cuda.device(q.device):
        cuda_build.launch(getattr(cuda_build.load("chunkwise_bw", _declare_bw), name), name, *args)


def _bw_setup(q, k, v, i, f, num_heads, c_states, den, dh, dc_last, qk_scale):
    B, S, H, DH, tensors = _check(q, k, v, i, f, num_heads, None, None)
    _check_bw(q, num_heads, c_states, den, dh, dc_last)
    _check_cuda(q, DH, tensors + [c_states, den, dh, dc_last])
    return B, S, DH, DH ** -0.5 if qk_scale is None else qk_scale


def _dc_scratch(q, num_heads, DH):
    B, S, _ = q.shape
    return torch.empty(B, -(-S // CHUNK_SIZE), num_heads, DH, DH, dtype=q.dtype, device=q.device)


def mlstm_siging_chunkwise_bw(q, k, v, i, f, num_heads: int, c_states, den, dh,
                              dc_last=None, eps: float = 1e-6,
                              qk_scale: float | None = None):
    """The backward of the cell, the denominator held constant.

    Takes the forward's inputs, its saved ``c_states`` and ``den`` (see
    :func:`mlstm_siging_chunkwise_fw_train`), the upstream gradient ``dh``
    (B, S, H) in q's dtype and optionally that of the last C state.
    Returns dq, dk, dv in q's dtype and dC0 (B, NH, DH, DH) float32, the
    gradient of the state before the first chunk.  For CUDA tensors the
    two passes (the dC scan into a scratch buffer, then dq/dk/dv of every
    chunk), one counted launch; CPU tensors take the plain version.
    """
    global LAUNCHES_BW
    if q.device.type == "cpu":
        return mlstm_siging_chunkwise_bw_plain(q, k, v, i, f, num_heads, c_states, den, dh,
                                               dc_last, eps=eps, qk_scale=qk_scale)
    B, S, DH, qk_scale = _bw_setup(q, k, v, i, f, num_heads, c_states, den, dh, dc_last,
                                   qk_scale)
    dcs = _dc_scratch(q, num_heads, DH)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dc0 = torch.empty(B, num_heads, DH, DH, dtype=torch.float32, device=q.device)
    _launch_bw("chunkwise_bw", q,
               *cuda_build.pointers(q, k, v, i, f, c_states, den, dh, dc_last, dq, dk, dv, dc0,
                                    dcs),
               B, S, num_heads, DH, _DTYPE_CODES[q.dtype], float(qk_scale), float(eps))
    LAUNCHES_BW += 1
    return dq, dk, dv, dc0


def mlstm_siging_chunkwise_bw_dc(q, f, num_heads: int, den, dh, dc_last=None,
                                 eps: float = 1e-6, qk_scale: float | None = None):
    """The first pass of the backward alone, the dC scan (kernel
    ``bw_dc_kernel``): see :func:`mlstm_siging_chunkwise_bw_dc_plain`, its
    plain version, which CPU tensors take.  Counts no launch."""
    if q.device.type == "cpu":
        return mlstm_siging_chunkwise_bw_dc_plain(q, f, num_heads, den, dh, dc_last, eps=eps,
                                                  qk_scale=qk_scale)
    # q and f stand in for k, v and i, which the pass does not read
    B, S, DH, qk_scale = _bw_setup(q, q, q, f, f, num_heads, None, den, dh, dc_last, qk_scale)
    dcs = _dc_scratch(q, num_heads, DH)
    dc0 = torch.empty(B, num_heads, DH, DH, dtype=torch.float32, device=q.device)
    _launch_bw("chunkwise_bw_dc", q, *cuda_build.pointers(q, f, den, dh, dc_last, dcs, dc0),
               B, S, num_heads, DH, _DTYPE_CODES[q.dtype], float(qk_scale), float(eps))
    return dcs, dc0


def mlstm_siging_chunkwise_bw_dqkv(q, k, v, i, f, num_heads: int, c_states, den, dh,
                                   dc_states, eps: float = 1e-6,
                                   qk_scale: float | None = None):
    """The second pass of the backward alone, dq, dk, dv of every chunk
    (kernel ``bw_dqkv_kernel``): see
    :func:`mlstm_siging_chunkwise_bw_dqkv_plain`, its plain version, which
    CPU tensors take.  Counts no launch."""
    if q.device.type == "cpu":
        return mlstm_siging_chunkwise_bw_dqkv_plain(q, k, v, i, f, num_heads, c_states, den, dh,
                                                    dc_states, eps=eps, qk_scale=qk_scale)
    B, S, DH, qk_scale = _bw_setup(q, k, v, i, f, num_heads, c_states, den, dh, None, qk_scale)
    if dc_states.shape != c_states.shape or dc_states.dtype != q.dtype:
        raise ValueError(f"dc_states must be {q.dtype} {tuple(c_states.shape)}")
    cuda_build.check_kernel_inputs(q, dc_states)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch_bw("chunkwise_bw_dqkv", q,
               *cuda_build.pointers(q, k, v, i, f, c_states, den, dh, dc_states, dq, dk, dv),
               B, S, num_heads, DH, _DTYPE_CODES[q.dtype], float(qk_scale), float(eps))
    return dq, dk, dv


def gate_grads(q, k, dq, dk, i, f, num_heads: int):
    """Gradients of the gate pre-activations from dq and dk, as the JAX
    package computes them beside its kernel (``chunkwise_v2._bw``):
    df = reverse-cumsum(q.dq - k.dk) * sigmoid(-f), di = k.dk * sigmoid(-i),
    with the dot products per head."""
    B, S, H = q.shape
    acc = acc_dtype(q.dtype)

    def rowdot(a, b):
        return (a.to(acc) * b.to(acc)).reshape(B, S, num_heads, H // num_heads).sum(-1)

    kdk = rowdot(k, dk)
    dfbar = rowdot(q, dq) - kdk
    dfrev = dfbar.flip(1).cumsum(1).flip(1)
    return kdk * torch.sigmoid(-i), dfrev * torch.sigmoid(-f)


class _ChunkwiseCell(torch.autograd.Function):
    """The cell with the kernels' forward and backward (``_core_fwd`` /
    ``_core_bwd``).  dn0 is zero and dC0 is returned when initial states
    were given; the gradient of n_last is dropped, as in the JAX VJP."""

    @staticmethod
    def forward(ctx, q, k, v, i, f, c_initial, n_initial, num_heads, eps, qk_scale):
        h, (c_last, n_last), (c_states, _, den) = mlstm_siging_chunkwise_fw_train(
            q, k, v, i, f, num_heads, c_initial, n_initial, eps=eps, qk_scale=qk_scale)
        ctx.save_for_backward(q, k, v, i, f, c_states, den)
        ctx.num_heads, ctx.eps, ctx.qk_scale = num_heads, eps, qk_scale
        ctx.n_initial_shape = None if n_initial is None else n_initial.shape
        ctx.mark_non_differentiable(n_last)
        ctx.set_materialize_grads(False)
        return h, c_last, n_last

    @staticmethod
    def backward(ctx, dh, dc_last, _dn_last):
        q, k, v, i, f, c_states, den = ctx.saved_tensors
        dh = torch.zeros_like(q) if dh is None else dh.contiguous()
        dc_last = None if dc_last is None else dc_last.contiguous()
        dq, dk, dv, dc0 = mlstm_siging_chunkwise_bw(
            q, k, v, i, f, ctx.num_heads, c_states, den, dh, dc_last,
            eps=ctx.eps, qk_scale=ctx.qk_scale)
        di, df = gate_grads(q, k, dq, dk, i, f, ctx.num_heads)
        had_init = ctx.n_initial_shape is not None
        dni = dc0.new_zeros(ctx.n_initial_shape) if had_init else None
        return dq, dk, dv, di, df, dc0 if had_init else None, dni, None, None, None


def mlstm_siging_chunkwise_train(q, k, v, i, f, num_heads: int, c_initial=None,
                                 n_initial=None, eps: float = 1e-6,
                                 qk_scale: float | None = None,
                                 return_last_states: bool = False):
    """The differentiable cell of training: the train forward kernel and the
    backward kernel (plain versions on CPU tensors).  Same interface and
    forward values as :func:`mlstm_siging_chunkwise_fw`."""
    h, c_last, n_last = _ChunkwiseCell.apply(q, k, v, i, f, c_initial, n_initial,
                                             num_heads, eps, qk_scale)
    return (h, (c_last, n_last)) if return_last_states else h


def mlstm_siging_chunkwise_v2_heads(q, k, v, i, f, chunk_size: int = 64, c_initial=None,
                                    n_initial=None, qk_scale: float | None = None,
                                    return_last_states: bool = False, eps: float = 1e-6):
    """The registry's ``chunkwise--pallas_xl_chunk_siging_v2``: the kernels
    of this module on (B, NH, S, DH) streams and (B, NH, S) gates, any S
    (``handles_ragged``).  The kernels hold their own chunk of 64 rows,
    so ``chunk_size`` does not change the function.  With a gradient to
    take it runs the differentiable cell, else the inference forward."""
    B, NH, S, DH = q.shape
    to_bsh = lambda x: x.transpose(1, 2).reshape(B, S, NH * DH).contiguous()  # noqa: E731
    grads = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, i, f, c_initial, n_initial))
    fn = mlstm_siging_chunkwise_train if grads else mlstm_siging_chunkwise_fw
    out = fn(to_bsh(q), to_bsh(k), to_bsh(v), i.transpose(1, 2).contiguous(),
             f.transpose(1, 2).contiguous(), NH, c_initial, n_initial, eps=eps,
             qk_scale=qk_scale, return_last_states=return_last_states)
    h, state = out if return_last_states else (out, None)
    h = h.reshape(B, S, NH, DH).transpose(1, 2)
    return (h, state) if return_last_states else h


mlstm_siging_chunkwise_v2_heads.handles_ragged = True


def mlstm_siging_chunkwise_train_plain(q, k, v, i, f, num_heads: int, c_initial=None,
                                       n_initial=None, eps: float = 1e-6,
                                       qk_scale: float | None = None,
                                       return_last_states: bool = False):
    """Plain version of :func:`mlstm_siging_chunkwise_train` on any device
    (float64 too): autograd through the plain forward with the denominator
    held constant."""
    B, S, H, DH, _ = _check(q, k, v, i, f, num_heads, c_initial, n_initial)
    h, state = mlstm_siging_chunkwise(
        _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads),
        i.transpose(1, 2), f.transpose(1, 2), chunk_size=CHUNK_SIZE,
        c_initial=c_initial, n_initial=n_initial, qk_scale=qk_scale,
        return_last_states=True, eps=eps, stopgrad_norm=True)
    h = h.transpose(1, 2).reshape(B, S, H)
    return (h, state) if return_last_states else h
