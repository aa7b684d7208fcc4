"""Model introspection: parameters, FLOPs, a per-op timer, and seeding.

Counterparts of ``init_seeds``, ``n_params``, ``get_flops``,
``model_info`` and ``profile_ops`` in ``xlstm_yolo_tpu/utils/model_utils.py``.

JAX counts FLOPs with XLA's cost analysis of the compiled program; the
port counts them with ``torch.utils.flop_counter.FlopCounterMode`` over one
forward, which counts the products (matmuls, convolutions) that PyTorch
dispatches.  A kernel bound with ``ctypes`` dispatches nothing, so each
mLSTM cell's recurrence is taken out of the counter on every device and
counted by formula instead: the chunkwise forward's
``4 * B * NH * S * DH * (L + DH)`` of ``chip_smoke.py``'s bounds over whole
chunks (S rounded up to a multiple of L: the kernels compute a ragged last
chunk's tile whole), L the route's chunk (64 for the v2 kernels, the
layer's ``chunk_size`` on a registry route).  The count then does not
depend on the device.
"""

from __future__ import annotations

import contextlib
import random
import time

import numpy as np
import torch


def init_seeds(seed: int = 0, deterministic: bool = True) -> torch.Generator:
    """Seed Python's and numpy's generators and torch's; returns a
    ``torch.Generator`` seeded with ``seed`` (the port draws its weights and
    stochastic depth from explicit generators).  ``deterministic`` also
    asks cuDNN for deterministic algorithms."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return torch.Generator().manual_seed(seed)


def n_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _cell_flops(cell, q: torch.Tensor) -> int:
    from xlstm_yolo_tpu_torch.ops.backend import V2_KERNEL
    from xlstm_yolo_tpu_torch.ops.chunkwise_v2 import CHUNK_SIZE

    B, S, H = q.shape
    NH = cell.num_heads
    DH = H // NH
    L = CHUNK_SIZE if cell.chunkwise_kernel == V2_KERNEL else cell.chunk_size
    return 4 * B * NH * (-(-S // L) * L) * DH * (L + DH)


@contextlib.contextmanager
def _cells_by_formula(model: torch.nn.Module, counted: list):
    """Within the block each mLSTM cell's recurrence runs outside every
    dispatch mode (so no flop counter sees it) and appends its formula's
    FLOPs to ``counted``."""
    from torch.utils._python_dispatch import _disable_current_modes

    from xlstm_yolo_tpu_torch.nn.layers import MatrixLSTMCell

    def wrap(cell, fn):
        def run(q, *args, **kw):
            counted.append(_cell_flops(cell, q))
            with _disable_current_modes():
                return fn(q, *args, **kw)
        return run

    saved = []
    for cell in (m for m in model.modules() if isinstance(m, MatrixLSTMCell)):
        # every way a cell reaches its recurrence (see MatrixLSTMCell.forward)
        for name in ("kernel", "train_kernel", "_registry_route", "_fused"):
            saved.append((cell, name, cell.__dict__.get(name)))
            object.__setattr__(cell, name, wrap(cell, getattr(cell, name)))
    try:
        yield
    finally:
        for cell, name, fn in saved:
            if fn is None:
                object.__delattr__(cell, name)
            else:
                object.__setattr__(cell, name, fn)


@torch.no_grad()
def get_flops(model: torch.nn.Module, imgsz: int = 640, batch: int = 1) -> float:
    """GFLOPs of one forward of ``model`` on a (batch, imgsz, imgsz, 3)
    image on the model's device; the same count on every device."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = next(model.parameters()).device
    x = torch.zeros((batch, imgsz, imgsz, 3), device=dev)
    counted: list[int] = []
    with _cells_by_formula(model, counted), FlopCounterMode(display=False) as fc:
        model(x)
    return (fc.get_total_flops() + sum(counted)) / 1e9


def model_info(model: torch.nn.Module, imgsz: int = 640, verbose: bool = True) -> dict:
    """Parameters and GFLOPs at ``imgsz`` (the keys of JAX's summary)."""
    gflops = get_flops(model, imgsz)
    info = {
        "params": n_params(model),
        "GFLOPs@{}px".format(imgsz): round(gflops, 1),
        "layers": len(getattr(model, "model", ())),
    }
    if verbose:
        print(", ".join(f"{k}: {v:,}" if isinstance(v, int) else f"{k}: {v}"
                        for k, v in info.items()))
    return info


def profile_ops(ops: list, n: int = 10, warmup: int = 2) -> list[dict]:
    """Time a list of ``(name, fn, args)`` device ops: ms per call over ``n``
    calls after ``warmup``, between CUDA events (host clock on the CPU), and
    each op's GFLOPs from ``FlopCounterMode`` (a ``ctypes`` kernel counts 0
    there: pass the module to :func:`get_flops` for a model)."""
    from torch.utils.flop_counter import FlopCounterMode

    rows = []
    for name, fn, args in ops:
        cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
        with torch.no_grad():
            for _ in range(warmup):
                fn(*args)
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    fn(*args)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / n
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn(*args)
                ms = (time.perf_counter() - t0) / n * 1e3
            with FlopCounterMode(display=False) as fc:
                fn(*args)
        rows.append({"op": name, "ms": round(ms, 3),
                     "gflops": round(fc.get_total_flops() / 1e9, 2)})
    return rows
