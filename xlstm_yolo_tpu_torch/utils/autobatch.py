"""Automatic batch-size selection from the card's memory.

Counterpart of ``xlstm_yolo_tpu/utils/autobatch.py``, with its selection
rule: climb the candidates in order and keep the largest whose footprint
fits ``fraction`` of the device's memory, stopping at the first that does
not.  JAX predicts each footprint from the compiled program; the port
runs the step once at each candidate and reads the allocator's peak
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``).
An out-of-memory error means "does not fit"; it is the one exception
caught.  Afterwards the allocator's cache is emptied and its peak counter
reset, so the phases after it start clean.  There is no device memory to
read on the CPU: there it raises.
"""

from __future__ import annotations

from typing import Callable

import torch


def device_memory_bytes() -> int:
    """The card's total memory in bytes."""
    if not torch.cuda.is_available():
        raise RuntimeError("autobatch reads the memory of a CUDA device; there is none")
    return int(torch.cuda.mem_get_info()[1])


def step_memory_bytes(make_step: Callable[[int], object], batch_size: int) -> int:
    """Peak bytes allocated while ``make_step(batch_size)`` runs one step,
    or -1 when it runs out of memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        make_step(batch_size)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return -1
    return int(torch.cuda.max_memory_allocated())


def autobatch(make_step: Callable[[int], object], imgsz: int = 640, fraction: float = 0.8,
              candidates=(4, 8, 16, 32, 64), peaks: dict | None = None) -> int:
    """The largest candidate batch size whose step fits ``fraction`` of the
    card's memory; ``make_step(batch_size)`` runs one step at that size.
    ``peaks``, when given, receives each tried candidate's peak bytes (-1:
    out of memory)."""
    limit = int(device_memory_bytes() * fraction)
    best = candidates[0]
    try:
        for bs in candidates:
            need = step_memory_bytes(make_step, bs)
            if peaks is not None:
                peaks[bs] = need
            if need < 0:
                break
            if need <= limit:
                best = bs
            else:
                break
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return best
