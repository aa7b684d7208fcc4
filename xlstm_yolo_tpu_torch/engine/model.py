"""Public facade: ``YOLO('vil-det-192.yaml').predict(images)``,
``YOLO('weights.pt').val(data='set.yaml')``,
``YOLO('vil-det-192.yaml').train(data='set.yaml', epochs=...)``,
``.export(format='torch' | 'torch_int8')``, ``.benchmark(data=...)``,
``.tune(data=..., iterations=...)`` and ``.info``.

Counterpart of ``YOLO`` in ``xlstm_yolo_tpu/engine/model.py``: its
``predict``, ``val``, ``train``, ``export`` (the port's own formats,
``engine/exporter.py``), ``benchmark`` (``utils/benchmarks.py``), ``tune``
(``engine/tuner.py``) and ``info``; ``track`` raises (ROADMAP Queue 1 item
12).  ``task`` picks the predictor and validator of ``models.yolo.model.
task_map`` (detect, segment, pose, obb, classify; the model YAML carries
the head); ``train`` trains the facade's task (JAX's facade leaves the
train config's ``task`` at detect unless the caller passes it).  The model
runs on the GPU unless the caller passes ``device="cpu"``, its mLSTM cells on
``chunkwise_kernel`` (``"auto"``: the v2 kernels;
``nn.tasks.resolve_chunkwise_kernel``).  A model YAML is built with random weights from seed 0, as the JAX facade's
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

from xlstm_yolo_tpu_torch.cfg import TASKS, VAL_DEFAULTS, get_cfg
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
    """User-facing facade: predict, val and train of every task."""

    def __init__(self, model: str | Path = "vil-det-192.yaml", task: str = "detect",
                 device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype = torch.bfloat16, chunkwise_kernel: str = "auto"):
        if task not in TASKS:
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
        from xlstm_yolo_tpu_torch.models.yolo.model import task_map

        args = {"imgsz": self.imgsz, **self.overrides, **kwargs}
        return task_map[self.task]["predictor"](args, self.model, self.names)(source,
                                                                                stream=stream)

    def __call__(self, source=None, **kwargs):
        return self.predict(source, **kwargs)

    def val(self, data=None, **kwargs) -> dict:
        """Validate on ``data`` (a dataset YAML or dict) with keys of
        ``VAL_DEFAULTS``; ``imgsz`` defaults to the model YAML's, as in
        ``predict``; for classify ``data`` is the folder of the split
        folders.  Returns ``results_dict``; ``self.validator`` keeps
        ``speed``, ``seen`` (detect: ``confusion_matrix`` and ``jdict``)."""
        args = {**VAL_DEFAULTS, "imgsz": self.imgsz, **self.overrides, **kwargs,
                **({"data": data} if data else {})}
        from xlstm_yolo_tpu_torch.models.yolo.model import task_map

        self.validator = task_map[self.task]["validator"](args)
        return self.validator(self.model)

    def add_callback(self, event: str, fn):
        """Register ``fn`` for a trainer or exporter event (``utils.callbacks.EVENTS``)."""
        self.callbacks.setdefault(event, []).append(fn)

    def _callbacks(self):
        from xlstm_yolo_tpu_torch.utils.callbacks import Callbacks

        cb = Callbacks()
        for event, fns in self.callbacks.items():
            for fn in fns:
                cb.add(event, fn)
        return cb

    def train(self, data=None, **kwargs) -> dict:
        """Train a model of this YAML (or, from a ``.pt``, vil-det-192
        starting from its weights) for the facade's task on ``data`` (a
        dataset YAML; classify: the folder of ``train/`` and ``val/``) with
        keys of the train config (``cfg/default.yaml``), on this facade's
        device, through ``engine.trainer.DetectionTrainer``.  Returns the
        final metrics; ``self.trainer`` keeps the trainer."""
        from xlstm_yolo_tpu_torch.engine.trainer import DetectionTrainer

        overrides = {"task": self.task, **self.overrides, **kwargs, "mode": "train"}
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

    def track(self, source=None, **kwargs):
        raise NotImplementedError("tracking is not ported (ROADMAP Queue 1 item 12)")

    def export(self, format: str = "torch", out_dir: str | Path = "runs/export", **kwargs) -> str:
        """Write the model in the port's ``format`` (``engine.exporter.FORMATS``:
        ``"torch"`` or ``"torch_int8"``) under ``out_dir`` with its sidecar;
        returns the file's path.  ``imgsz`` defaults to the model YAML's."""
        from xlstm_yolo_tpu_torch.engine.exporter import Exporter

        args = get_cfg(overrides={"imgsz": self.imgsz, **self.overrides, **kwargs,
                                  "mode": "export", "format": format,
                                  "model": self.model_cfg, "task": self.task})
        return Exporter(args, self._callbacks())(self.model, out_dir=out_dir)

    def benchmark(self, **kwargs) -> list[dict]:
        """Rows of speed (and mAP with ``data=``) per format
        (``utils.benchmarks.benchmark``)."""
        from xlstm_yolo_tpu_torch.utils.benchmarks import benchmark

        return benchmark(self, **kwargs)

    def tune(self, data=None, use_ray: bool = False, iterations: int = 10,
             epochs_per_iter: int = 5, save_dir: str = "runs/tune", **kwargs):
        """Hyperparameter search: mutation evolution (``engine.tuner.Tuner``,
        each generation trained on this facade's device), or Ray Tune with
        ``use_ray=True`` (which raises where Ray is not installed).  Returns
        (best hyperparameters, best fitness)."""
        if use_ray:
            from xlstm_yolo_tpu_torch.engine.tuner import run_ray_tune

            return run_ray_tune(self, max_samples=iterations,
                                **({"data": data} if data else {}), **kwargs)
        from xlstm_yolo_tpu_torch.engine.tuner import Tuner

        args = {**self.overrides, **kwargs, "task": self.task}
        data = data or args.pop("data", None)
        tuner = Tuner(args, save_dir=save_dir, device=self.device)
        return tuner(self.model_cfg, data, iterations=iterations,
                     epochs_per_iter=epochs_per_iter)

    @property
    def info(self) -> dict:
        from xlstm_yolo_tpu_torch.utils.model_utils import n_params

        return {"params": n_params(self.model), "cfg": self.model_cfg}
