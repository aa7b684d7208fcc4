"""Public facade: ``YOLO('vil-det-192.yaml').predict(images)``.

Counterpart of ``YOLO.__init__`` / ``_resolve`` / ``predict`` in
``xlstm_yolo_tpu/engine/model.py``.  The model runs on the GPU unless the
caller passes ``device="cpu"``.  It is built from the YAML with random
weights from seed 0, as the JAX facade's ``PRNGKey(0)`` (checkpoint
loading is not ported yet: load a state dict into ``YOLO.model`` for
trained weights, or call ``build_detection_model(generator=...)``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import torch

from xlstm_yolo_tpu_torch.engine.predictor import DetectionPredictor
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


class YOLO:
    """User-facing facade (detect task, predict mode)."""

    def __init__(self, model: str | Path = "vil-det-192.yaml", task: str = "detect",
                 device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype = torch.bfloat16):
        if task != "detect":
            raise NotImplementedError(f"task {task!r} is not ported yet")
        self.task = task
        self.device = select_device(device)
        self.overrides: dict[str, Any] = {}
        self.names = dict(COCO_NAMES)
        self.model_cfg = self._resolve(model)
        self.model, d = build_detection_model(
            self.model_cfg, compute_dtype=compute_dtype, device=self.device,
            generator=torch.Generator().manual_seed(0))
        self.imgsz = int(d.get("imgsz", 640))

    @staticmethod
    def _resolve(model) -> str:
        p = Path(model)
        if p.suffix not in {".yaml", ".yml"}:
            raise NotImplementedError(f"only model YAMLs load so far, got {model!r}")
        if not p.exists() and (CFG_MODELS / p.name).exists():
            p = CFG_MODELS / p.name
        if not p.exists():
            raise FileNotFoundError(f"model yaml not found: {model}")
        return str(p)

    def predict(self, source=None, stream: bool = False, **kwargs):
        args = {"imgsz": self.imgsz, **self.overrides, **kwargs}
        return DetectionPredictor(args, self.model, self.names)(source, stream=stream)

    def __call__(self, source=None, **kwargs):
        return self.predict(source, **kwargs)
