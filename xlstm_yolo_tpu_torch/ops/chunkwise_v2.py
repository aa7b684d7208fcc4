"""Chunkwise siging mLSTM forward in the (B, S, H) layout: the CUDA kernel,
its wrapper and its plain PyTorch version.

Counterpart of ``xlstm_yolo_tpu/ops/pallas/chunkwise_v2.py`` ``_fw`` with
``save_states=False`` (the inference kernel ``_fw_kernel_infer``).  The
kernel is ``csrc/chunkwise_fw.cu``, compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface at first use and loaded
with ``ctypes``.

:func:`mlstm_siging_chunkwise_fw` launches the kernel for CUDA tensors and
raises on anything the kernel does not take; for CPU tensors it runs
:func:`mlstm_siging_chunkwise_fw_plain`, the same function in plain
PyTorch.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from xlstm_yolo_tpu_torch.ops.mlstm_chunkwise import mlstm_siging_chunkwise
from xlstm_yolo_tpu_torch.utils.torch_utils import acc_dtype

__all__ = [
    "LAUNCHES",
    "build_kernel",
    "mlstm_siging_chunkwise_fw",
    "mlstm_siging_chunkwise_fw_plain",
]

LAUNCHES = 0  # kernel launches made by mlstm_siging_chunkwise_fw

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "chunkwise_fw.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CHUNK_SIZE = 64  # the kernel's chunk length (csrc/chunkwise_fw.cu, L)
HEAD_DIMS = (16, 32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the chunkwise kernel cannot be built")
    return found


def build_kernel() -> tuple[Path, str]:
    """Compile ``csrc/chunkwise_fw.cu`` unless a library of this source
    exists.  Returns the library path and the compiler's output (empty
    when the library was already built).  Raises if the build fails."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"chunkwise_fw-{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def _library():
    global _lib
    if _lib is None:
        path, _ = build_kernel()
        lib = ctypes.CDLL(str(path))
        fn = lib.chunkwise_fw
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def mlstm_siging_chunkwise_fw_plain(q, k, v, i, f, num_heads: int, c_initial=None,
                                    n_initial=None, eps: float = 1e-6,
                                    qk_scale: float | None = None,
                                    return_last_states: bool = False):
    """Plain PyTorch version of the kernel: same interface, any device, and
    float64 streams too (with float64 gates and states), for a reference."""
    B, S, H, DH, _ = _check(q, k, v, i, f, num_heads, c_initial, n_initial)
    NH = num_heads

    def heads(x):
        return x.reshape(B, S, NH, DH).transpose(1, 2)

    out = mlstm_siging_chunkwise(
        heads(q), heads(k), heads(v), i.transpose(1, 2), f.transpose(1, 2),
        chunk_size=CHUNK_SIZE, c_initial=c_initial, n_initial=n_initial,
        qk_scale=qk_scale, return_last_states=True, eps=eps,
    )
    h, state = out
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
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q/k/v dtype {q.dtype} not supported by the kernel "
                        "(float32 or bfloat16)")
    B, S, H, DH, tensors = _check(q, k, v, i, f, num_heads, c_initial, n_initial)
    if DH not in HEAD_DIMS:
        raise ValueError(f"head dim {DH} not supported by the kernel {HEAD_DIMS}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")
    if qk_scale is None:
        qk_scale = DH ** -0.5
    lib = _library()
    h = torch.empty_like(q)
    c_last = torch.empty(B, num_heads, DH, DH, dtype=torch.float32, device=q.device)
    n_last = torch.empty(B, num_heads, DH, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.chunkwise_fw(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i.data_ptr(), f.data_ptr(),
            c_initial.data_ptr() if c_initial is not None else None,
            n_initial.data_ptr() if n_initial is not None else None,
            h.data_ptr(), c_last.data_ptr(), n_last.data_ptr(),
            B, S, num_heads, DH, _DTYPE_CODES[q.dtype], float(qk_scale), float(eps), stream,
        )
    if err != 0:
        raise RuntimeError(f"chunkwise_fw launch failed: CUDA error {err}")
    LAUNCHES += 1
    return (h, (c_last, n_last)) if return_last_states else h
