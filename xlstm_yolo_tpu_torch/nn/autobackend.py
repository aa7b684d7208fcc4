"""One inference interface over the weight formats the port reads.

Counterpart of ``xlstm_yolo_tpu/nn/autobackend.py:27-172`` for the port's
formats: a model YAML (random weights from seed 0, as ``YOLO``) and a
``.pt`` file of the port's own (a state dict, a ``{"ema"|"model": ...}``
dict of one, or a training checkpoint of ``utils.checkpoint``, whose EMA
parameters and BatchNorm statistics are taken), read with
``weights_only=True`` and loaded strictly.  A ``torch_int8`` export
(``engine.exporter``: int8 ``{"q", "s"}`` pairs) is dequantized to float32
first, as JAX's backend reads ``orbax_int8``; ``self.format`` is then
``"torch_int8"``.

Like JAX's, the backend configures itself from the ``{name}.meta.json``
sidecar that the port's checkpoints carry (``utils/checkpoint.py``): the
model YAML (``args.model``), ``imgsz``, the task and the class names (from
the dataset YAML of ``args.data`` when it exists); ``nc`` follows the names.
With ``fuse`` (the default) every BatchNorm is folded into its conv
(``utils.fuse.fuse_state_dict``, ``build_detection_model(fused=True)``);
a fold that fails raises, where JAX's keeps the unfused model.  A model
with a Segment or Classify head stays unfused (``self.fused`` False), as
JAX's backend leaves it: JAX builds those heads without folded BatchNorms,
so its fold of them always fails.  ``predictor(cfg)`` is the task's
predictor (``models.yolo.model.task_map``, the sidecar's task) on the
backend's model.  An orbax
directory, ``.stablehlo`` or ``.tflite`` file raises, naming the format.
``forward(img_u8)`` maps (B, imgsz, imgsz, 3) uint8 RGB to (B, max_det, 6)
(a task head: its decoded anchor rows).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
import yaml

from xlstm_yolo_tpu_torch.engine.model import load_checkpoint_state
from xlstm_yolo_tpu_torch.nn.tasks import UNFUSABLE_HEADS, build_detection_model
from xlstm_yolo_tpu_torch.utils.fuse import fuse_state_dict
from xlstm_yolo_tpu_torch.utils.quantize import dequantize_state_dict, is_quantized_state_dict
from xlstm_yolo_tpu_torch.utils.torch_utils import select_device

_OTHER_FORMATS = {".stablehlo": "StableHLO", ".tflite": "TFLite"}


def read_meta(weights: Path) -> dict:
    """The ``{name}.meta.json`` sidecar of ``weights``, or {}."""
    meta = weights.parent / f"{weights.name}.meta.json"
    return json.loads(meta.read_text()) if meta.is_file() else {}


def _names_of(data) -> dict[int, str] | None:
    if not data or not Path(str(data)).is_file():
        return None
    names = (yaml.safe_load(Path(str(data)).read_text()) or {}).get("names")
    if isinstance(names, list):
        names = dict(enumerate(names))
    return {int(k): str(v) for k, v in names.items()} if isinstance(names, dict) else None


def checkpoint_state_dict(path: Path, model: torch.nn.Module) -> dict:
    """The model state dict held by the ``.pt`` file at ``path``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "ema_params" in ckpt:  # a training checkpoint
        return {**(ckpt["ema_params"] or ckpt["params"]), **ckpt.get("batch_stats", {})}
    return load_checkpoint_state(path, model)


class AutoBackend:
    def __init__(self, weights: str | Path, model_cfg: str | Path | None = None,
                 imgsz: int | None = None, compute_dtype: torch.dtype = torch.bfloat16,
                 fuse: bool = True, device: str | torch.device = "cuda"):
        p = Path(weights)
        self.device = select_device(device)
        if p.is_dir():
            raise NotImplementedError(f"{weights}: orbax checkpoint directories are JAX's "
                                      "format; the port reads model YAMLs and .pt files")
        if p.suffix in _OTHER_FORMATS:
            raise NotImplementedError(f"{weights}: {_OTHER_FORMATS[p.suffix]} weights are not "
                                      "read by the port (model YAMLs and .pt files are)")
        self.meta = read_meta(p) if p.suffix == ".pt" else {}
        args = self.meta.get("args", {})
        model_cfg = model_cfg or args.get("model")
        imgsz = imgsz or args.get("imgsz")
        self.task = args.get("task") or "detect"
        self.names: dict[int, str] | None = _names_of(args.get("data"))
        nc = len(self.names) if self.names else None

        if p.suffix in {".yaml", ".yml"}:
            self.format, model_cfg = "yaml", p
        elif p.suffix == ".pt":
            self.format = "torch"
            if not p.is_file():
                raise FileNotFoundError(f"weights not found: {weights}")
            if not model_cfg:
                raise ValueError(f"{weights}: .pt weights need a model YAML (model_cfg=, or "
                                 "args.model in its .meta.json sidecar)")
        else:
            raise ValueError(f"unsupported weights format: {weights}")
        build = dict(nc=nc, compute_dtype=compute_dtype, device=self.device)
        model, d = build_detection_model(model_cfg, **build)
        if self.format == "torch":
            sd = checkpoint_state_dict(p, model)
            if is_quantized_state_dict(sd):  # an int8 weight-only export
                self.format = "torch_int8"
                sd = dequantize_state_dict(sd)
            model.load_state_dict(sd, strict=True)
        self.imgsz = int(imgsz or d.get("imgsz", 640))
        if self.names is None:
            self.names = {i: f"class{i}" for i in range(int(d.get("nc", 80)))}
        self.fused = fuse and not any(s["module"] in UNFUSABLE_HEADS for s in model.specs)
        if self.fused:
            fused, _ = build_detection_model(model_cfg, fused=True, **build)
            fused.load_state_dict(fuse_state_dict(model.state_dict()), strict=True)
            model = fused
        self.model_cfg = str(model_cfg)
        self.model = model

    def predictor(self, cfg: dict | None = None):
        """The task's predictor over this model, at the backend's ``imgsz``
        unless ``cfg`` sets one."""
        from xlstm_yolo_tpu_torch.models.yolo.model import task_map

        return task_map[self.task]["predictor"]({"imgsz": self.imgsz, **(cfg or {})},
                                                self.model, self.names)

    @torch.inference_mode()
    def forward(self, img_u8) -> torch.Tensor:
        x = torch.as_tensor(img_u8, device=self.device)
        return self.model(x.float() / 255.0)[0]

    __call__ = forward

    def warmup(self, batch: int = 1):
        self.forward(torch.zeros((batch, self.imgsz, self.imgsz, 3), dtype=torch.uint8,
                                 device=self.device))
        return self
