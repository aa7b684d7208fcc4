"""Event callback bus (counterpart of ``Callbacks`` in
``xlstm_yolo_tpu/utils/callbacks/__init__.py``): the same event names.
The TensorBoard writer and the other integrations are not ported."""

from __future__ import annotations

from collections import defaultdict
from typing import Callable

EVENTS = [
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end", "on_fit_epoch_end", "on_model_save",
    "on_train_end", "on_params_update", "teardown",
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    "on_predict_start", "on_predict_batch_start", "on_predict_batch_end",
    "on_predict_postprocess_end", "on_predict_end",
    "on_export_start", "on_export_end",
]


class Callbacks:
    def __init__(self):
        self._hooks: dict[str, list[Callable]] = defaultdict(list)

    def add(self, event: str, fn: Callable):
        if event not in EVENTS:
            raise KeyError(f"unknown event '{event}'")
        self._hooks[event].append(fn)

    def run(self, event: str, *args, **kwargs):
        for fn in self._hooks.get(event, []):
            fn(*args, **kwargs)

    def get(self, event: str):
        return list(self._hooks.get(event, []))
