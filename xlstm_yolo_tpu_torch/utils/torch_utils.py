"""Device selection for the port's entry points, and device outputs
fetched to the host."""

from __future__ import annotations

import torch


def select_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: the GPU unless the caller asks
    for the CPU.  Raises when a CUDA device is asked for and none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type norms, gates and the mLSTM recurrence compute in: float32,
    or float64 for float64 inputs (the port's float64 reference forward)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def to_host(out, n: int | None = None):
    """A device output (a tensor, or a tuple of them) as numpy, each cut to
    its first ``n`` rows (all where ``n`` is None), floats in float32."""
    if isinstance(out, tuple):
        return tuple(to_host(t, n) for t in out)
    t = out[:n]
    return (t.float() if t.is_floating_point() else t).cpu().numpy()
