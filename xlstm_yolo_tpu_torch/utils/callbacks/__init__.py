"""Event callback bus (counterparts of ``Callbacks`` and ``add_tensorboard``
in ``xlstm_yolo_tpu/utils/callbacks/__init__.py``): the same event names;
the TensorBoard writer is ``torch.utils.tensorboard``'s, and registers
nothing where the ``tensorboard`` package is absent.  The other
integrations are in ``integrations.py``."""

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


def add_tensorboard(callbacks: Callbacks, log_dir: str) -> bool:
    """Write each epoch's metrics as TensorBoard scalars under ``log_dir``;
    False (and nothing registered) without the ``tensorboard`` package."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return False

    writer = SummaryWriter(log_dir)

    def on_fit_epoch_end(trainer):
        for k, v in (trainer.metrics or {}).items():
            try:
                writer.add_scalar(k, float(v), trainer.epoch)
            except (TypeError, ValueError):
                pass
        writer.flush()

    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    callbacks.add("on_train_end", lambda trainer: writer.close())
    return True
