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
from xlstm_yolo_tpu_torch.ops.cuda_build import F, I, P
from xlstm_yolo_tpu_torch.ops.mlstm_recurrent import mlstm_siging_step

__all__ = ["LAUNCHES", "mlstm_siging_step_kernel"]

LAUNCHES = 0  # launches of the step kernel

HEAD_DIMS = (16, 32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib):
    lib.mlstm_step.argtypes = [P] * 10 + [I] * 3 + [F, F, P]
    lib.mlstm_step.restype = I


def _check(q, k, v, i, f, c_state, n_state):
    if q.ndim != 3:
        raise ValueError(f"q must be (B, NH, DH), got {tuple(q.shape)}")
    B, NH, DH = q.shape
    want = {"k": (k, q.shape, q.dtype), "v": (v, q.shape, q.dtype),
            "i": (i, (B, NH), torch.float32), "f": (f, (B, NH), torch.float32),
            "c_state": (c_state, (B, NH, DH, DH), torch.float32),
            "n_state": (n_state, (B, NH, DH), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got {tuple(t.shape)} {t.dtype}")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q/k/v dtype {q.dtype} not supported by the kernel "
                        "(float32 or bfloat16)")
    if DH not in HEAD_DIMS:
        raise ValueError(f"head dim {DH} not supported by the kernel {HEAD_DIMS}")


def mlstm_siging_step_kernel(q, k, v, i, f, c_state, n_state, qk_scale: float | None = None,
                             normalize: bool = True, eps: float = 1e-6):
    """One token: q, k, v (B, NH, DH) float32 or bfloat16, i, f (B, NH)
    float32 pre-activations, c_state (B, NH, DH, DH) and n_state (B, NH, DH)
    float32.

        C' = sig(f) C + sig(i) k v^T;  n' = sig(f) n + sig(i) k
        h  = (qs C') / (max(|qs . n'|, 1) + eps),  qs = q / sqrt(DH)

    Returns h (B, NH, DH) in q's dtype and (C', n') in new float32 tensors.
    Views (the inference wrapper's token) are copied to contiguous tensors
    for the kernel."""
    global LAUNCHES
    if not normalize:
        raise NotImplementedError("the unnormalized variant is not implemented, as in the JAX "
                                  "package's kernel")
    if q.device.type == "cpu":
        return mlstm_siging_step(q, k, v, i, f, c_state, n_state, qk_scale=qk_scale, eps=eps)
    _check(q, k, v, i, f, c_state, n_state)
    q, k, v, i, f, c_state, n_state = (t.contiguous() for t in (q, k, v, i, f, c_state, n_state))
    cuda_build.check_kernel_inputs(q, k, v, i, f, c_state, n_state)
    B, NH, DH = q.shape
    scale = DH ** -0.5 if qk_scale is None else qk_scale
    lib = cuda_build.load("step", _declare)
    h = torch.empty_like(q)
    c_new, n_new = torch.empty_like(c_state), torch.empty_like(n_state)
    with torch.cuda.device(q.device):
        cuda_build.launch(lib.mlstm_step, "mlstm_step",
                          *cuda_build.pointers(q, k, v, i, f, c_state, n_state, h, c_new, n_new),
                          B * NH, DH, _DTYPE_CODES[q.dtype], float(scale), float(eps))
    LAUNCHES += 1
    return h, (c_new, n_new)
