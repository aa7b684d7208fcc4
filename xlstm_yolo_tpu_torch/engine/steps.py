"""The training step of the detector.

Counterpart of ``TrainState`` (the tree form) and ``make_train_step`` in
``xlstm_yolo_tpu/engine/steps.py``, for ``task="detect"``,
``end2end=True`` and ``accumulate=1``: forward of the train-mode model,
the E2E loss, backward, gradient clipping, AdEMAMix and the EMA.  The
state holds the model's own parameters and BatchNorm buffers, and the step
updates them, the optimizer moments and the EMA in place; it returns the
state with its step count advanced and the metrics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from xlstm_yolo_tpu_torch.engine import optimizers as opt_lib
from xlstm_yolo_tpu_torch.nn.layers import set_droppath_generator
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
from xlstm_yolo_tpu_torch.utils.convert import jax_leaf_names
from xlstm_yolo_tpu_torch.utils.loss import e2e_detect_loss

_ROADMAP = "not ported (ROADMAP Queue 1 item 7)"


@dataclass
class TrainState:
    step: int
    params: dict[str, nn.Parameter]      # the model's parameters, by state-dict name
    batch_stats: dict[str, torch.Tensor]  # its BatchNorm running statistics
    opt_state: Any
    ema: opt_lib.EMAState

    @classmethod
    def create(cls, model: nn.Module, tx: opt_lib.Transform) -> "TrainState":
        params = dict(model.named_parameters())
        stats = {n: b for n, b in model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))}
        plist = list(params.values())
        return cls(0, params, stats, tx.init(plist), opt_lib.ema_init(plist))


def optimizer_leaves(model: nn.Module) -> list[tuple[str, int]]:
    """(JAX leaf name, ndim) of each parameter, in parameter order: what
    :func:`opt_lib.build_optimizer` groups by."""
    names = jax_leaf_names(model)
    return [(names[n], p.ndim) for n, p in model.named_parameters()]


def detect_loss(model_train: nn.Module, batch: dict, nc: int = 80,
                generator: torch.Generator | None = None):
    """Forward of the train-mode model on ``batch`` and its E2E loss:
    (loss, LossItems).  uint8 images are normalised on their device."""
    img = batch["img"]
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    set_droppath_generator(model_train, generator)
    out = model_train(img)
    strides = [img.shape[1] / f.shape[1] for f in out["one2many"]]
    return e2e_detect_loss(out, batch["cls"], batch["bboxes"], batch["mask"], strides, nc=nc)


def make_train_step(model_train: nn.Module, tx: opt_lib.Transform, nc: int = 80,
                    end2end: bool = True, ema_decay: float = 0.9999, accumulate: int = 1,
                    task: str = "detect", kpt_shape=None, imgsz_out=None,
                    device_aug=None) -> Callable:
    """Build ``train_step(state, batch, generator) -> (state, metrics)``.

    ``batch``: img (B, H, W, 3) uint8 (normalised on the device) or float
    in [0, 1]; cls (B, M) ints; bboxes (B, M, 4) xyxy in image units; mask
    (B, M) bool.  ``generator`` draws the stochastic-depth masks.  metrics
    holds the loss and its box, cls and dfl items as 0-d tensors.
    """
    if not end2end or accumulate != 1 or task != "detect" or kpt_shape is not None \
            or imgsz_out is not None or device_aug:
        raise NotImplementedError(
            f"train step with end2end={end2end}, accumulate={accumulate}, task={task!r}, "
            f"kpt_shape={kpt_shape}, imgsz_out={imgsz_out}, device_aug={device_aug}: {_ROADMAP}")

    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None = None):
        loss, items = detect_loss(model_train, batch, nc, generator)
        params = list(state.params.values())
        grads = torch.autograd.grad(loss, params)
        updates, state.opt_state = tx.update(list(grads), state.opt_state, params)
        with torch.no_grad():
            torch._foreach_add_(params, updates)
            state.ema = opt_lib.ema_update(state.ema, params, decay=ema_decay)
        state.step += 1
        metrics = {"loss": loss.detach(), "box_loss": items.box.detach(),
                   "cls_loss": items.cls.detach(), "dfl_loss": items.dfl.detach()}
        return state, metrics

    return train_step


def detect_trainer(cfg="vil-det-192.yaml", device: str | torch.device = "cuda",
                   compute_dtype: torch.dtype | None = torch.bfloat16,
                   generator: torch.Generator | None = None, chunkwise_kernel: str = "auto",
                   **optimizer_kw):
    """The training entry point: the detector of ``cfg`` in train mode on
    ``device`` (the GPU unless the caller passes ``device="cpu"``), its
    mLSTM cells on ``chunkwise_kernel`` (``"auto"``: the v2 kernels), float32
    parameters with ``compute_dtype`` activations, its AdEMAMix transform
    (``optimizer_kw`` go to :func:`opt_lib.build_optimizer`), the state and
    the step.  Returns ``(model, state, train_step)``."""
    model, d = build_detection_model(cfg, compute_dtype=compute_dtype, device=device,
                                     generator=generator, training=True,
                                     chunkwise_kernel=chunkwise_kernel)
    tx, _, _ = opt_lib.build_optimizer(optimizer_leaves(model), **optimizer_kw)
    state = TrainState.create(model, tx)
    return model, state, make_train_step(model, tx, nc=int(d.get("nc", 80)))
