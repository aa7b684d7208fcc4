"""Build the port's host C++ sources and load them with ``ctypes``.

The counterpart of :mod:`ops.cuda_build` for code that runs on the CPU
(``csrc/<name>.cpp``, e.g. the JPEG decoder): ``g++`` compiles each source
into ``build/<name>-<digest>.so``, where the digest covers the source and
the flags, at its first use.  A failed build raises.  ``ctypes.CDLL``
releases the GIL around every call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable

from xlstm_yolo_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC

CXX_FLAGS = ["-O3", "-std=c++17", "-fwrapv", "-shared", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """The library of ``csrc/<name>.cpp``, compiled unless it exists."""
    path = library_path(name)
    if path.exists():
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++) to build {name}.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(CSRC / f"{name}.cpp")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{name}: g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builds leave one whole library
    return path


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cpp`` (built if needed), with its
    functions' argument types set by ``declare``."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build(name)))
                declare(lib)
                _libs[name] = lib
    return lib
