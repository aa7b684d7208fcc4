"""Benchmarks: the speed (and mAP) table across the port's formats, and the
mLSTM kernel sweep.

Counterparts of ``measure_throughput``, ``benchmark``,
``KernelBenchConfig`` and ``run_kernel_benchmark`` in
``xlstm_yolo_tpu/utils/benchmarks.py``.  Times come from CUDA events around
the calls on the card (the host clock on the CPU), after warm-up calls, on
distinct device-resident inputs; JAX's relay-safe chained timing is not
needed here.

Where JAX turns every exception of a format into a status row, the port
turns only the refusal of a JAX-only format into one (it comes before any
launch); any other exception propagates, so a kernel's failure never shows
as a row.
"""

from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass, field
from itertools import product
from pathlib import Path
from types import SimpleNamespace
from typing import Callable

import torch


def time_calls(fn: Callable, args_list: list, warmup: int = 2) -> float:
    """Seconds per call of ``fn(*args)`` over ``args_list`` after ``warmup``
    calls on its first entries: CUDA events when the first argument is on
    the card, else the host clock."""
    cuda = isinstance(args_list[0][0], torch.Tensor) and args_list[0][0].is_cuda
    for args in args_list[:warmup]:
        fn(*args)
    timed = args_list[warmup:]
    if cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for args in timed:
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / len(timed)
    t0 = time.perf_counter()
    for args in timed:
        fn(*args)
    return (time.perf_counter() - t0) / len(timed)


def measure_throughput(fn: Callable, make_input: Callable, iters: int = 16,
                       warmup: int = 2) -> float:
    """Seconds per call of ``fn(x)``; ``make_input(seed)`` gives each call a
    distinct device-resident input, all made before the timing."""
    inputs = [(make_input(seed),) for seed in range(warmup + iters)]
    return time_calls(fn, inputs, warmup)


def benchmark(model, imgsz: int = 640, batch: int = 8,
              formats=("eager", "torch", "torch_int8"), data=None, verbose: bool = True,
              out_dir=None) -> list[dict]:
    """Speed (and, with ``data``, mAP) rows of ``model`` (a ``YOLO``) per
    format: ``"eager"`` the facade's module (JAX's ``"jit"``), ``"torch"``
    and ``"torch_int8"`` exported by ``engine.exporter``, reloaded by
    ``AutoBackend(fuse=False)`` and timed through its forward; with ``data``
    each row's model is validated by ``DetectionValidator`` (its mAP50-95).
    A JAX-only format's row holds the refusal; any other error raises."""
    from xlstm_yolo_tpu_torch.engine.exporter import Exporter, check_format
    from xlstm_yolo_tpu_torch.engine.validator import DetectionValidator
    from xlstm_yolo_tpu_torch.nn.autobackend import AutoBackend

    module, dev = model.model, model.device
    out_dir = Path(out_dir) if out_dir else Path(tempfile.mkdtemp(prefix="bench_fmt_"))

    @torch.inference_mode()
    def predict(img_u8):
        return module(img_u8.float() / 255.0)[0]

    def make_input(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, 255, (batch, imgsz, imgsz, 3), dtype=torch.uint8,
                             device=dev, generator=g)

    def val_map(m, fmt) -> float | None:
        if data is None:
            return None
        cfg = dict(data=str(data), imgsz=imgsz, batch=batch, workers=0, plots=False,
                   save_json=False, save_dir=str(out_dir / fmt / "val"))
        res = DetectionValidator(cfg)(m)
        return float(res.get("metrics/mAP50-95(B)", float("nan")))

    rows = []
    for fmt in formats:
        if fmt == "eager":
            sec = measure_throughput(predict, make_input)
            m = val_map(module, fmt)
        else:
            try:
                check_format(fmt)
            except ValueError as e:  # a JAX-only format, refused before any launch
                rows.append({"format": fmt, "status": f"{type(e).__name__}: {e}"})
                continue
            args = SimpleNamespace(format=fmt, imgsz=imgsz, batch=batch,
                                   model=model.model_cfg, task=model.task, data=data)
            path = Exporter(args)(module, out_dir=out_dir / fmt)
            ab = AutoBackend(path, imgsz=imgsz, fuse=False, device=dev,
                             compute_dtype=module.compute_dtype)
            sec = measure_throughput(ab.forward, make_input)
            m = val_map(ab.model, fmt)
        rows.append({
            "format": fmt, "status": "ok", "imgsz": imgsz, "batch": batch,
            "ms/img": round(sec / batch * 1e3, 2),
            "img/s": round(batch / sec, 1),
            "mAP50-95": None if m is None else round(m, 4),
        })
    if verbose:
        for r in rows:
            print(r)
    return rows


@dataclass
class KernelBenchConfig:
    """The kernel sweep's grid (JAX's defaults)."""

    kernel_names: list = field(default_factory=lambda: [
        "chunkwise--native_autograd", "chunkwise--pallas_xl_chunk_siging",
    ])
    B: list = field(default_factory=lambda: [2])
    NH: list = field(default_factory=lambda: [12])
    S: list = field(default_factory=lambda: [1024, 6656])
    DH: list = field(default_factory=lambda: [32])
    chunk_size: list = field(default_factory=lambda: [256, 512])
    with_backward: bool = False


def run_kernel_benchmark(cfg: KernelBenchConfig | None = None, device: str = "cuda",
                         iters: int = 10, warmup: int = 2) -> list[dict]:
    """Each registry name of ``cfg`` at each (B, NH, S, DH, chunk) with S a
    multiple of the chunk: ms per forward call on (B, NH, S, DH) bf16 streams
    and float32 gates, and with ``with_backward`` also ms per forward and
    backward (the gradients of sum(h**2) for q, k and v)."""
    from xlstm_yolo_tpu_torch.ops.backend import get_mlstm_kernel
    from xlstm_yolo_tpu_torch.utils.torch_utils import select_device

    cfg = cfg or KernelBenchConfig()
    dev = select_device(device)
    rows = []
    for name, B, NH, S, DH, L in product(
        cfg.kernel_names, cfg.B, cfg.NH, cfg.S, cfg.DH, cfg.chunk_size
    ):
        if S % L:
            continue
        kern = get_mlstm_kernel(name)
        g = torch.Generator(device=dev).manual_seed(0)
        qkv = [torch.randn((B, NH, S, DH), generator=g, device=dev).bfloat16()
               for _ in range(3)]
        gates = [torch.randn((B, NH, S), generator=g, device=dev) for _ in range(2)]

        def forward(q, k, v, i, f):
            with torch.no_grad():
                return kern(q, k, v, i, f, chunk_size=L)

        args = [(*qkv, *gates)] * (warmup + iters)
        row = {"kernel": name, "B": B, "NH": NH, "S": S, "DH": DH, "chunk": L,
               "ms": round(time_calls(forward, args, warmup) * 1e3, 3)}
        if cfg.with_backward:
            leaves = [t.detach().requires_grad_() for t in qkv]

            def forward_backward(q, k, v, i, f):
                h = kern(q, k, v, i, f, chunk_size=L)
                return torch.autograd.grad((h.float() ** 2).sum(), (q, k, v))

            args = [(*leaves, *gates)] * (warmup + iters)
            row["ms_fwd_bwd"] = round(time_calls(forward_backward, args, warmup) * 1e3, 3)
        rows.append(row)
    return rows
