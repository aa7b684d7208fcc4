"""Configuration of the port and its command line.

``default.yaml`` (a byte-for-byte copy of the JAX package's) with
``load_default_cfg``, ``_coerce`` and ``get_cfg`` (counterparts of JAX
``cfg/__init__.py``), the trainer's configuration; the keys of it that the
predictor and the validator read; and the CLI, ``entrypoint`` (the
``yolo-tpu-torch`` script, ``python -m xlstm_yolo_tpu_torch.cfg``):
``yolo-tpu-torch [task] mode key=value ...`` builds ``YOLO(model, device=)``
(``model`` defaults to ``vil-det-192.yaml``, ``device`` to the GPU;
``device=cpu`` runs on the CPU) and calls the mode with the other keys;
the special words ``version``, ``cfg``, ``checks`` and ``settings`` behave
as JAX's (``checks`` reports torch, CUDA and the device).  ``model``,
``source`` and ``device`` stay strings (JAX's ``_coerce`` would turn
``source=0`` into a float).  The model YAMLs are in ``cfg/models``."""

from __future__ import annotations

import difflib
from pathlib import Path
from types import SimpleNamespace
from typing import Any

import yaml

CFG_DIR = Path(__file__).resolve().parent
DEFAULT_CFG_PATH = CFG_DIR / "default.yaml"

_FLOAT_01_KEYS = {
    "dropout", "fraction", "hsv_h", "hsv_s", "hsv_v", "translate", "scale",
    "fliplr", "flipud", "mosaic", "mixup", "copy_paste", "conf", "iou", "lr0",
    "lrf", "momentum", "weight_decay",
}
_INT_KEYS = {"epochs", "patience", "workers", "seed", "close_mosaic", "max_det",
             "vid_stride", "save_period", "nbs", "max_targets"}
_BOOL_KEYS = {"save", "cache", "exist_ok", "pretrained", "verbose", "deterministic",
              "single_cls", "rect", "cos_lr", "resume", "amp", "profile", "val",
              "save_json", "save_hybrid", "half", "dnn", "plots", "visualize",
              "augment", "agnostic_nms", "retina_masks", "multi_scale",
              "stream_buffer", "keras", "optimize", "int8", "dynamic", "simplify",
              "nms"}

TASKS = {"detect", "segment", "pose", "obb", "classify"}
MODES = {"train", "val", "predict", "track", "export", "benchmark", "tune"}
#: special first words of the CLI (``hub`` is not ported, as in JAX)
SPECIAL = {"settings", "version", "checks", "cfg", "solutions"}
_STRING_KEYS = {"model", "source", "device"}  # kept as the CLI gives them


def load_default_cfg() -> dict:
    with open(DEFAULT_CFG_PATH) as fh:
        return yaml.safe_load(fh)


def _coerce(k: str, v: Any) -> Any:
    if v is None or v == "None" or v == "":
        return None
    if k in _BOOL_KEYS and isinstance(v, str):
        return v.lower() == "true"
    if k in _INT_KEYS and v is not None:
        return int(v)
    if isinstance(v, str):
        try:
            fv = float(v)
            return int(fv) if fv.is_integer() and k in _INT_KEYS else fv
        except ValueError:
            return v
    return v


def get_cfg(cfg: dict | str | Path | None = None, overrides: dict | None = None) -> SimpleNamespace:
    """Defaults <- ``cfg`` (a dict or YAML path) <- ``overrides``; an unknown
    override key raises a KeyError naming the closest key, and a
    fraction-like key outside [0, 1] a ValueError."""
    base = load_default_cfg()
    if cfg is not None:
        if isinstance(cfg, (str, Path)):
            with open(cfg) as fh:
                cfg = yaml.safe_load(fh)
        base.update({k: v for k, v in dict(cfg).items() if v is not None})
    if overrides:
        for k, v in overrides.items():
            if k not in base:
                close = difflib.get_close_matches(k, base.keys(), n=1)
                hint = f" — did you mean '{close[0]}'?" if close else ""
                raise KeyError(f"'{k}' is not a valid config key{hint}")
            base[k] = _coerce(k, v)
    for k in _FLOAT_01_KEYS:
        v = base.get(k)
        if isinstance(v, (int, float)) and k not in {"lr0", "lrf", "momentum", "weight_decay"}:
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"'{k}={v}' must be in [0, 1]")
    return SimpleNamespace(**base)


PREDICT_DEFAULTS = {
    "conf": None,  # None -> 0.25
    "iou": 0.7,
    "max_det": 300,
    "imgsz": 640,
    "batch": 16,
    "classes": None,
    "augment": False,  # test-time augmentation (nn.tasks.predict_augment)
    "vid_stride": 1,  # read by the loaders; video sources are not ported
}

VAL_DEFAULTS = {
    "data": None,  # dataset yaml
    "batch": 16,
    "imgsz": 640,
    "conf": None,  # None -> 0.001
    "iou": 0.7,  # read by no detect validator: the v10 head needs no NMS
    "max_det": 300,
    "split": "val",
    "save_json": False,
    "plots": True,  # the confusion matrix; the figures are not ported
    "workers": 8,
    "max_targets": 128,
    "single_cls": False,
    "save_dir": None,  # None -> runs/val (predictions.json with save_json)
}


def _handle_special(cmd: str, rest: list[str]) -> Any:
    if cmd == "version":
        from importlib.metadata import PackageNotFoundError, version as _v

        try:
            v = _v("xlstm-yolo-tpu")
        except PackageNotFoundError:
            v = "0.1.0 (source checkout)"
        print(v)
        return v
    if cmd == "cfg":
        cfg = load_default_cfg()
        print("\n".join(f"{k}={cfg[k]}" for k in sorted(cfg)))
        return cfg
    if cmd == "checks":
        import torch

        from xlstm_yolo_tpu_torch.utils.checks import check_cuda_backend

        backend = check_cuda_backend()
        info = {
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "backend": backend,
            "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                        if backend == "cuda" else ["cpu"]),
        }
        for k, v in info.items():
            print(f"{k}: {v}")
        return info
    if cmd == "settings":
        from xlstm_yolo_tpu_torch import utils

        settings = utils.SETTINGS
        if rest and rest[0] == "reset":
            settings.reset()
            print("settings reset")
        else:
            for a in rest:
                if "=" in a:
                    k, v = a.split("=", 1)
                    # settings keys are not cfg keys: generic YAML coercion
                    settings.update(**{k: yaml.safe_load(v)})
            settings.save()
        for k, v in sorted(settings.items()):
            print(f"{k}={v}")
        return dict(settings)
    raise NotImplementedError("the solutions are not ported (ROADMAP Queue 1 item 12)")


def entrypoint(argv: list[str] | None = None) -> Any:
    """CLI: ``yolo-tpu-torch [task] mode key=value ...`` or a special word."""
    import sys

    args = argv if argv is not None else sys.argv[1:]
    if not args or args[0] in {"-h", "--help", "help"}:
        print("usage: yolo-tpu-torch [task] mode key=value ...\n"
              f"  tasks: {sorted(TASKS)}\n  modes: {sorted(MODES)}\n"
              f"  special: {sorted(SPECIAL)}")
        return None
    if args[0] in SPECIAL:
        return _handle_special(args[0], list(args[1:]))

    task, mode = "detect", None
    overrides: dict[str, Any] = {}
    for a in args:
        if "=" in a:
            k, v = a.split("=", 1)
            overrides[k] = v if k in _STRING_KEYS else _coerce(k, v)
        elif a in TASKS:
            task = a
        elif a in MODES:
            mode = a
        else:
            raise ValueError(f"unrecognized argument '{a}'")
    if mode is None:
        raise ValueError(f"a mode is required: {sorted(MODES)}")

    from xlstm_yolo_tpu_torch.engine.model import YOLO

    model_path = overrides.pop("model", None) or "vil-det-192.yaml"
    device = overrides.pop("device", None) or "cuda"
    model = YOLO(model_path, task=task, device=str(device))
    return getattr(model, mode)(**overrides)
