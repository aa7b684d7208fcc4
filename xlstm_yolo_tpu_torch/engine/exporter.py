"""Model export to the port's own format.

Counterpart of ``xlstm_yolo_tpu/engine/exporter.py``.  The JAX package
exports a StableHLO program, orbax checkpoints (float and int8) and TF
files; the port writes its own checkpoint format, which
``nn.autobackend.AutoBackend`` and ``YOLO("....pt")`` read:

- ``"torch"``: ``model.pt``, the model's state dict in the reference's
  names (float32 parameters and BatchNorm statistics), the counterpart of
  ``orbax``;
- ``"torch_int8"``: ``model_int8.pt``, the same with every parameter of at
  least 2 dimensions and 1024 elements as an int8 ``{"q", "s"}`` pair
  (``utils.quantize``, weight-only, per output channel), the counterpart of
  ``orbax_int8``.

Each file has the ``{name}.meta.json`` sidecar that ``AutoBackend`` reads
(``args``: the model YAML, ``imgsz``, ``task`` and ``data``; for int8 also
``quantization``), and ``metadata.json`` beside it, as JAX writes.  A JAX
format name raises a ValueError before anything is written: the port has
no serialized-program format (its kernels are bound with ``ctypes``, which
``torch.export`` cannot trace).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from xlstm_yolo_tpu_torch.utils.callbacks import Callbacks
from xlstm_yolo_tpu_torch.utils.quantize import channel_axes, quantize_state_dict

FORMATS = {
    # name: (file, description)
    "torch": ("model.pt", "state dict in the reference's names (counterpart of orbax)"),
    "torch_int8": ("model_int8.pt", "state dict, int8 weight-only PTQ (counterpart of "
                                    "orbax_int8)"),
}
JAX_FORMATS = ("stablehlo", "orbax", "orbax_int8", "savedmodel", "tflite")
QUANTIZATION = "int8 weight-only, per-output-channel symmetric"


def export_formats():
    """Table of the port's export formats."""
    return [{"format": k, "suffix": v[0], "description": v[1]} for k, v in FORMATS.items()]


def check_format(fmt: str) -> str:
    """``fmt`` lower-cased if the port exports it; a ValueError otherwise."""
    fmt = (fmt or "torch").lower()
    if fmt in JAX_FORMATS:
        raise ValueError(f"export format '{fmt}' is the JAX package's; the port exports "
                         f"{list(FORMATS)}")
    if fmt not in FORMATS:
        raise ValueError(f"unknown export format '{fmt}'; available {list(FORMATS)}")
    return fmt


class Exporter:
    """``Exporter(args)(model, out_dir)``: ``args`` has ``format``, ``imgsz``
    and ``batch``, and for the sidecar ``model`` (the model YAML), ``task``
    and ``data``; returns the written file's path."""

    def __init__(self, args, callbacks: Callbacks | None = None):
        self.args = args
        self.callbacks = callbacks or Callbacks()

    def __call__(self, model: torch.nn.Module, out_dir: str | Path = "runs/export") -> str:
        fmt = check_format(self.args.format)
        self.callbacks.run("on_export_start", self)
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.time()
        imgsz = int(self.args.imgsz)
        meta = {
            "format": fmt,
            "imgsz": imgsz,
            "batch": int(self.args.batch or 1),
            "output": "(batch, max_det, 6) [xyxy(pixels@imgsz), conf, cls]",
            "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        }
        sidecar = {"args": {"model": str(self.args.model), "imgsz": imgsz,
                            "task": getattr(self.args, "task", None) or "detect",
                            "data": getattr(self.args, "data", None)}}
        state = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
        if fmt == "torch_int8":
            state = quantize_state_dict(state, channel_axes(model))
            meta["quantization"] = sidecar["quantization"] = QUANTIZATION
        path = out_dir / FORMATS[fmt][0]
        torch.save(state, path)
        (out_dir / f"{path.name}.meta.json").write_text(json.dumps(sidecar, indent=2))
        (out_dir / "metadata.json").write_text(json.dumps(meta, indent=2))
        self.file = path
        print(f"export: {fmt} -> {path} ({time.time() - t0:.1f}s)")
        self.callbacks.run("on_export_end", self)
        return str(path)
