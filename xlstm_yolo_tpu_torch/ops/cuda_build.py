"""Build the port's CUDA sources and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/<name>-<digest>.so``,
where the digest covers the source, the headers of ``csrc/`` and the
flags.  A library is built at
its first use, or ahead of time with :func:`build_all`, which starts one
``nvcc`` per source at once.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("chunkwise_fw", "chunkwise_bw", "epilogue_bw", "ffn_bw", "chunkwise_v1_fw",
           "chunkwise_v1_bw", "chunkwise_exp_fw", "chunkwise_exp_bw", "parallel_fw",
           "parallel_bw", "step", "tal_metric", "slstm", "chunkwise_fw3")

HEAD_DIMS = (16, 32, 64, 128)  # the mLSTM kernels' head dims (port::dispatch_dh, csrc/common.cuh)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Sequence[str] = SOURCES) -> dict[str, dict]:
    """Compile every source of ``names`` that has no library yet, one
    ``nvcc`` per source, all started together.  Returns, per name, the
    library path, the compiler's output (empty when it was already
    built) and the seconds it took.  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running, out = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"library": path, "log": "", "seconds": 0.0}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, path)
    failed = []
    for name, (proc, tmp, path) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"library": path, "log": log, "seconds": time.perf_counter() - t0}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` (built if needed), with its
    functions' argument types set by ``declare``."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]["library"]
        lib = ctypes.CDLL(str(path))
        declare(lib)
        _libs[name] = lib
    return lib


def pointers(*tensors) -> list:
    """data_ptr of each tensor, None for None."""
    return [None if t is None else t.data_ptr() for t in tensors]


def check_kernel_inputs(*tensors) -> None:
    """Raise unless every given tensor is on one CUDA device, contiguous
    and 16-byte aligned."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"unsupported device(s) {sorted(map(str, devices))}: the kernels "
                         "take tensors on one CUDA device")
    for t in tensors:
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")


def row_stride(t) -> int:
    """The row stride, in elements, of a (B, S, W) stream that the mLSTM
    kernels read row by row (q, k, v; e.g. a split view of one
    projection).  Raises unless its last dim is contiguous, its rows are a
    multiple of 16 bytes apart and do not overlap, its batches lie S rows
    apart and its start is 16-byte aligned."""
    B, S, W = t.shape
    rs = t.stride(1) if S > 1 else (t.stride(0) if B > 1 else W)
    if (t.stride(2) != 1 or rs < W or rs * t.element_size() % 16 or t.data_ptr() % 16
            or (B > 1 and t.stride(0) != S * rs)):
        raise ValueError(f"a layout the kernels cannot take: shape {tuple(t.shape)}, strides "
                         f"{t.stride()} (last dim contiguous, rows a multiple of 16 bytes "
                         "apart, batches S rows apart)")
    return rs


def stream_handle(device: int) -> int:
    """The current CUDA stream of device index ``device``, as the handle a
    C launcher takes: PyTorch's raw getter where it has one (no Stream
    object is made), else ``torch.cuda.current_stream(device).cuda_stream``."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(device) if raw is not None else torch.cuda.current_stream(device).cuda_stream


def launch_on(fn, name: str, device: int, *args) -> None:
    """Call a C launcher on the current stream of device index ``device``,
    entering that device's context only where it is not the current one;
    raise on a CUDA error."""
    import torch

    if device == torch.cuda.current_device():
        err = fn(*args, stream_handle(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream_handle(device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def launch(fn, name: str, *args) -> None:
    """Call a C launcher on the current device's current stream; raise on a
    CUDA error."""
    import torch

    launch_on(fn, name, torch.cuda.current_device(), *args)


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
