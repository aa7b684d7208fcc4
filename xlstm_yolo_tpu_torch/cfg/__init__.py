"""Configuration of the port: ``default.yaml`` (a byte-for-byte copy of the
JAX package's) with ``load_default_cfg``, ``_coerce`` and ``get_cfg``
(counterparts of JAX ``cfg/__init__.py``), the trainer's configuration;
and the keys of it that the predictor and the validator read.  The model
YAMLs are in ``cfg/models``."""

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
