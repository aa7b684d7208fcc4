"""Public facade: ``YOLO('vil-det-192.yaml').predict(images)``,
``YOLO('weights.pt').val(data='set.yaml')``,
``YOLO('vil-det-192.yaml').train(data='set.yaml', epochs=...)``.

Counterpart of ``YOLO.__init__`` / ``_resolve`` / ``predict`` / ``val`` /
``train`` in
``xlstm_yolo_tpu/engine/model.py``.  The model runs on the GPU unless the
caller passes ``device="cpu"``, its mLSTM cells on ``chunkwise_kernel``
(``"auto"``: the v2 kernels; ``nn.tasks.resolve_chunkwise_kernel``).  A
model YAML is built with random weights from seed 0, as the JAX facade's
``PRNGKey(0)``.  A ``.pt`` checkpoint builds ``vil-det-192.yaml``, as the
JAX facade does, and loads the checkpoint's ``ema`` (else ``model``, else
the file itself) as a state dict in the reference's names:
``torch.load(weights_only=True)``, so a checkpoint that pickles module
objects is refused; the keys JAX's converter ignores (``.dfl.``,
``num_batches_tracked``) are dropped, and any other missing or extra key
raises (``load_state_dict(strict=True)``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import torch

from xlstm_yolo_tpu_torch.cfg import VAL_DEFAULTS
from xlstm_yolo_tpu_torch.engine.predictor import DetectionPredictor
from xlstm_yolo_tpu_torch.engine.validator import DetectionValidator
from xlstm_yolo_tpu_torch.nn.tasks import CFG_MODELS, build_detection_model
from xlstm_yolo_tpu_torch.utils.torch_utils import select_device

COCO_NAMES = {
    0: "person", 1: "bicycle", 2: "car", 3: "motorcycle", 4: "airplane", 5: "bus",
    6: "train", 7: "truck", 8: "boat", 9: "traffic light", 10: "fire hydrant",
    11: "stop sign", 12: "parking meter", 13: "bench", 14: "bird", 15: "cat",
    16: "dog", 17: "horse", 18: "sheep", 19: "cow", 20: "elephant", 21: "bear",
    22: "zebra", 23: "giraffe", 24: "backpack", 25: "umbrella", 26: "handbag",
    27: "tie", 28: "suitcase", 29: "frisbee", 30: "skis", 31: "snowboard",
    32: "sports ball", 33: "kite", 34: "baseball bat", 35: "baseball glove",
    36: "skateboard", 37: "surfboard", 38: "tennis racket", 39: "bottle",
    40: "wine glass", 41: "cup", 42: "fork", 43: "knife", 44: "spoon", 45: "bowl",
    46: "banana", 47: "apple", 48: "sandwich", 49: "orange", 50: "broccoli",
    51: "carrot", 52: "hot dog", 53: "pizza", 54: "donut", 55: "cake", 56: "chair",
    57: "couch", 58: "potted plant", 59: "bed", 60: "dining table", 61: "toilet",
    62: "tv", 63: "laptop", 64: "mouse", 65: "remote", 66: "keyboard",
    67: "cell phone", 68: "microwave", 69: "oven", 70: "toaster", 71: "sink",
    72: "refrigerator", 73: "book", 74: "clock", 75: "vase", 76: "scissors",
    77: "teddy bear", 78: "hair drier", 79: "toothbrush",
}


def load_checkpoint_state(path: str | Path, model: torch.nn.Module) -> dict:
    """The state dict of a ``.pt`` checkpoint, without the keys the JAX
    converter ignores that ``model`` does not hold."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    tm = ckpt.get("ema") or ckpt.get("model") or ckpt
    sd = tm.state_dict() if hasattr(tm, "state_dict") else tm
    held = model.state_dict()
    return {k: v for k, v in sd.items()
            if k in held or not (".dfl." in k or k.endswith("num_batches_tracked"))}


class YOLO:
    """User-facing facade (detect task: predict, val and train)."""

    def __init__(self, model: str | Path = "vil-det-192.yaml", task: str = "detect",
                 device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype = torch.bfloat16, chunkwise_kernel: str = "auto"):
        if task != "detect":
            raise NotImplementedError(f"task {task!r} is not ported yet")
        self.task = task
        self.device = select_device(device)
        self.overrides: dict[str, Any] = {}
        self.names = dict(COCO_NAMES)
        self.model_cfg, self.ckpt_path = self._resolve(model)
        self.model, d = build_detection_model(
            self.model_cfg, compute_dtype=compute_dtype, device=self.device,
            generator=torch.Generator().manual_seed(0), chunkwise_kernel=chunkwise_kernel)
        if self.ckpt_path:
            self.model.load_state_dict(load_checkpoint_state(self.ckpt_path, self.model),
                                       strict=True)
        self.imgsz = int(d.get("imgsz", 640))
        self.callbacks: dict[str, list] = {}

    @staticmethod
    def _resolve(model) -> tuple[str, str | None]:
        """(model YAML, checkpoint path or None)."""
        p = Path(model)
        if p.suffix == ".pt":
            if not p.is_file():
                raise FileNotFoundError(f"checkpoint not found: {model}")
            return str(CFG_MODELS / "vil-det-192.yaml"), str(p)
        if p.suffix not in {".yaml", ".yml"}:
            raise NotImplementedError(f"only model YAMLs and .pt checkpoints load, got {model!r}")
        if not p.exists() and (CFG_MODELS / p.name).exists():
            p = CFG_MODELS / p.name
        if not p.exists():
            raise FileNotFoundError(f"model yaml not found: {model}")
        return str(p), None

    def predict(self, source=None, stream: bool = False, **kwargs):
        """Results for ``source``: an image file, a directory or glob of them,
        a list of paths, a BGR numpy image or a list of them, a PIL-like
        image, or a BHWC/BCHW tensor (``data.loaders.load_inference_source``),
        with keys of ``PREDICT_DEFAULTS``."""
        args = {"imgsz": self.imgsz, **self.overrides, **kwargs}
        return DetectionPredictor(args, self.model, self.names)(source, stream=stream)

    def __call__(self, source=None, **kwargs):
        return self.predict(source, **kwargs)

    def val(self, data=None, **kwargs) -> dict:
        """Validate on ``data`` (a dataset YAML or dict) with keys of
        ``VAL_DEFAULTS``; ``imgsz`` defaults to the model YAML's, as in
        ``predict``.  Returns ``results_dict``; ``self.validator`` keeps
        ``speed``, ``seen``, ``confusion_matrix`` and ``jdict``."""
        args = {**VAL_DEFAULTS, "imgsz": self.imgsz, **self.overrides, **kwargs,
                **({"data": data} if data else {})}
        self.validator = DetectionValidator(args)
        return self.validator(self.model)

    def add_callback(self, event: str, fn):
        """Register ``fn(trainer)`` for a trainer event (``utils.callbacks.EVENTS``)."""
        self.callbacks.setdefault(event, []).append(fn)

    def train(self, data=None, **kwargs) -> dict:
        """Train a detector of this YAML (or, from a ``.pt``, vil-det-192
        starting from its weights) on ``data`` with keys of the train
        config (``cfg/default.yaml``), on this facade's device, through
        ``engine.trainer.DetectionTrainer``.  Returns the final metrics;
        ``self.trainer`` keeps the trainer."""
        from xlstm_yolo_tpu_torch.engine.trainer import DetectionTrainer

        overrides = {**self.overrides, **kwargs, "mode": "train"}
        if data:
            overrides["data"] = data
        if self.ckpt_path and "pretrained" not in overrides:
            overrides["pretrained"] = self.ckpt_path
        trainer = DetectionTrainer(overrides=overrides, model_cfg=self.model_cfg,
                                   device=self.device)
        for event, fns in self.callbacks.items():
            for fn in fns:
                trainer.callbacks.add(event, fn)
        metrics = trainer.train()
        self.trainer = trainer
        return metrics
