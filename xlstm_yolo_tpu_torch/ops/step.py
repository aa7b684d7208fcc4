"""One-token siging mLSTM step: the CUDA kernel and its wrapper.

Counterpart of ``xlstm_yolo_tpu/ops/pallas/step.py``, the registry's
``step--pallas``: :func:`mlstm_siging_step_kernel` updates (C, n) and emits h
for one token per (batch, head) with kernel ``mlstm_step`` in
``csrc/step.cu``.  Its plain version is
:func:`~xlstm_yolo_tpu_torch.ops.mlstm_recurrent.mlstm_siging_step` (the
registry's ``step--native``), which CPU tensors go through; CUDA tensors
launch the kernel or raise.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from xlstm_yolo_tpu_torch.ops import cuda_build
from xlstm_yolo_tpu_torch.ops.cuda_build import HEAD_DIMS, F, I, P
from xlstm_yolo_tpu_torch.ops.mlstm_recurrent import mlstm_siging_step

__all__ = ["LAUNCHES", "mlstm_siging_step_kernel"]

LAUNCHES = 0  # launches of the step kernel

_F32, _BF16 = torch.float32, torch.bfloat16  # the storage types of q, k, v and h
_launcher = None  # the library's mlstm_step, loaded at the first launch


def _declare(lib):
    lib.mlstm_step.argtypes = [P] * 10 + [I] * 3 + [F, F, P]
    lib.mlstm_step.restype = I


def _check(q, k, v, i, f, c_state, n_state):
    """Raise, naming the first input the kernel does not take."""
    if q.ndim != 3:
        raise ValueError(f"q must be (B, NH, DH), got {tuple(q.shape)}")
    B, NH, DH = q.shape
    want = {"k": (k, q.shape, q.dtype), "v": (v, q.shape, q.dtype),
            "i": (i, (B, NH), _F32), "f": (f, (B, NH), _F32),
            "c_state": (c_state, (B, NH, DH, DH), _F32),
            "n_state": (n_state, (B, NH, DH), _F32)}
    for name, (t, shape, dtype) in want.items():
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got {tuple(t.shape)} {t.dtype}")
    if DH not in HEAD_DIMS:
        raise ValueError(f"head dim {DH} not supported by the kernel {HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (_F32, _BF16):
        raise TypeError(f"q/k/v dtype {q.dtype} not supported by the kernel "
                        "(float32 or bfloat16)")
    cuda_build.check_kernel_inputs(*(t.contiguous() for t in (q, k, v, i, f, c_state, n_state)))


def mlstm_siging_step_kernel(q, k, v, i, f, c_state, n_state, qk_scale: float | None = None,
                             normalize: bool = True, eps: float = 1e-6):
    """One token: q, k, v (B, NH, DH) float32 or bfloat16, i, f (B, NH)
    float32 pre-activations, c_state (B, NH, DH, DH) and n_state (B, NH, DH)
    float32.

        C' = sig(f) C + sig(i) k v^T;  n' = sig(f) n + sig(i) k
        h  = (qs C') / (max(|qs . n'|, 1) + eps),  qs = q / sqrt(DH)

    Returns h (B, NH, DH) in q's dtype and (C', n') in new float32 tensors.
    Views that are not contiguous are copied to contiguous tensors for the
    kernel; the inference wrapper's token (``q[:, :, 0]`` of (B, NH, 1,
    DH)) is contiguous already.

    The checks of shape, dtype, device, head dim, contiguity and alignment
    run in one pass, and the launch enters no device context where the
    tensors lie on the current device: a decode makes one call a token."""
    global LAUNCHES, _launcher
    if not normalize:
        raise NotImplementedError("the unnormalized variant is not implemented, as in the JAX "
                                  "package's kernel")
    if not q.is_cuda:
        if q.is_cpu:
            return mlstm_siging_step(q, k, v, i, f, c_state, n_state, qk_scale=qk_scale,
                                     eps=eps)
        _check(q, k, v, i, f, c_state, n_state)
    shape, dt, dev = q.shape, q.dtype, q.get_device()
    if len(shape) != 3:
        _check(q, k, v, i, f, c_state, n_state)
    B, NH, DH = shape
    if not (k.shape == shape and v.shape == shape and n_state.shape == shape
            and c_state.shape == (B, NH, DH, DH) and i.shape == (B, NH) and f.shape == (B, NH)
            and (dt is _F32 or dt is _BF16) and k.dtype is dt and v.dtype is dt
            and i.dtype is _F32 and f.dtype is _F32 and c_state.dtype is _F32
            and n_state.dtype is _F32 and DH in HEAD_DIMS
            and k.get_device() == dev and v.get_device() == dev and i.get_device() == dev
            and f.get_device() == dev and c_state.get_device() == dev
            and n_state.get_device() == dev):
        _check(q, k, v, i, f, c_state, n_state)
    ts = [q, k, v, i, f, c_state, n_state]
    ptrs = []
    for j, t in enumerate(ts):
        if not t.is_contiguous():
            ts[j] = t = t.contiguous()
        ptr = t.data_ptr()
        if ptr & 15:
            raise ValueError("kernel inputs must be 16-byte aligned")
        ptrs.append(ptr)
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    if _launcher is None:
        _launcher = cuda_build.load("step", _declare).mlstm_step
    h = torch.empty_like(ts[0])
    c_new, n_new = torch.empty_like(ts[5]), torch.empty_like(ts[6])
    cuda_build.launch_on(_launcher, "mlstm_step", dev, *ptrs, h.data_ptr(), c_new.data_ptr(),
                         n_new.data_ptr(), B * NH, DH, 0 if dt is _F32 else 1, float(scale),
                         float(eps))
    LAUNCHES += 1
    return h, (c_new, n_new)
