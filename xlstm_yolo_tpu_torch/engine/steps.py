"""The training step of the detector and of the task models.

Counterpart of ``TrainState`` (the tree form) and ``make_train_step`` in
``xlstm_yolo_tpu/engine/steps.py``, with ``end2end=True``: forward of the
train-mode model, the task's loss (detect: the E2E loss; segment, pose,
obb and classify: ``utils.loss``'s task losses, dispatched as JAX's step
dispatches them), backward,
gradient clipping, the optimizer and the EMA.  With ``accumulate`` k > 1 the
batch has a leading microbatch dimension of k: the step runs each
microbatch's forward and backward in turn, sums their losses and
gradients (JAX's scan), threads the BatchNorm statistics through them (the
train-mode forward updates the model's buffers), and reports the loss
items of the last; then one clip, one update and one EMA update.  The
state holds the model's own parameters and BatchNorm buffers, and the step
updates them, the optimizer state and the EMA in place; it returns the
state with its step count advanced and the metrics, under JAX's four
names whatever the task; the task's own terms of the last microbatch
(segment's mask term, pose's keypoint and visibility terms, classify's
cross-entropy) are the step function's ``terms``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from xlstm_yolo_tpu_torch.cfg import TASKS
from xlstm_yolo_tpu_torch.engine import optimizers as opt_lib
from xlstm_yolo_tpu_torch.nn.layers import set_droppath_generator
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
from xlstm_yolo_tpu_torch.utils.convert import jax_leaf_names
from xlstm_yolo_tpu_torch.utils.loss import (
    LossItems,
    e2e_detect_loss,
    v8_classification_loss,
    v8_obb_loss,
    v8_pose_loss,
    v8_segmentation_loss,
)
from xlstm_yolo_tpu_torch.utils.resize import resize


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


def rescale_batch(img: torch.Tensor, bboxes: torch.Tensor, imgsz_out: int | None):
    """:func:`rescale_task_batch` of the images and the boxes: (img, bboxes)."""
    out = rescale_task_batch({"img": img, "bboxes": bboxes}, imgsz_out)
    return out["img"], out["bboxes"]


def rescale_task_batch(batch: dict, imgsz_out: int | None) -> dict:
    """A multi-scale bucket's batch: the (B, H, W, 3) images resized
    bilinearly to ``imgsz_out`` square on their device (the JAX resize,
    :mod:`xlstm_yolo_tpu_torch.utils.resize`), and the boxes, the
    keypoints' x and y and the rotated boxes' x, y, w and h scaled by
    ``imgsz_out / H``; unchanged without a bucket or at H.  uint8 images are
    normalised to float32 / 255 first."""
    img = batch["img"]
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    batch = {**batch, "img": img}
    ih = img.shape[1]
    if imgsz_out and imgsz_out != ih:
        sf = imgsz_out / ih
        batch["img"] = resize(img, (img.shape[0], imgsz_out, imgsz_out, img.shape[-1]),
                              "bilinear")
        if "bboxes" in batch:
            batch["bboxes"] = batch["bboxes"] * sf
        if "kpts" in batch:
            k = batch["kpts"].float()
            batch["kpts"] = torch.cat([k[..., :2] * sf, k[..., 2:]], -1)
        if "rboxes" in batch:
            rb = batch["rboxes"].float()
            batch["rboxes"] = torch.cat([rb[..., :4] * sf, rb[..., 4:]], -1)
    return batch


def task_loss(model_train: nn.Module, batch: dict, task: str = "detect", nc: int = 80,
              kpt_shape=None, generator: torch.Generator | None = None,
              imgsz_out: int | None = None):
    """Forward of the train-mode model on ``batch`` and its task's loss:
    (loss, LossItems, the task's own terms as a dict).  uint8 images are
    normalised on their device; with ``imgsz_out`` the batch is first
    rescaled (:func:`rescale_task_batch`), and the loss's strides follow from
    the resized images.  Segment's gt masks are resized to the prototypes' grid
    (JAX's ``"nearest"``) only where their shapes differ."""
    batch = rescale_task_batch(batch, imgsz_out)
    img = batch["img"]
    ih = img.shape[1]
    set_droppath_generator(model_train, generator)
    out = model_train(img)
    if task == "classify":
        total, l = v8_classification_loss(out, batch["cls"])
        return total, LossItems(l, l, torch.zeros_like(l)), {"cls": l}
    strides = [ih / f.shape[1] for f in out["one2many"]]
    gts = (batch["cls"], batch["bboxes"], batch["mask"])
    if task == "segment":
        gt_masks = batch["masks"]
        Hm, Wm = out["proto"].shape[1:3]
        if tuple(gt_masks.shape[-2:]) != (Hm, Wm):
            gt_masks = resize(gt_masks, (*gt_masks.shape[:2], Hm, Wm), "nearest")
        total, items, seg = v8_segmentation_loss(out, *gts, gt_masks, strides, img_size=ih,
                                                 nc=nc)
        return total, items, {"seg": seg}
    if task == "pose":
        total, items, (kpt, kobj) = v8_pose_loss(out, *gts, batch["kpts"], strides, nc=nc,
                                                 kpt_shape=tuple(kpt_shape or (17, 3)))
        return total, items, {"pose": kpt, "kobj": kobj}
    if task == "obb":
        total, items = v8_obb_loss(out, batch["cls"], batch["rboxes"], batch["mask"], strides,
                                   nc=nc)
        return total, items, {"box": items.box}
    total, items = e2e_detect_loss(out, *gts, strides, nc=nc)
    return total, items, {}


def detect_loss(model_train: nn.Module, batch: dict, nc: int = 80,
                generator: torch.Generator | None = None, imgsz_out: int | None = None):
    """:func:`task_loss` of the detect task: (loss, LossItems)."""
    return task_loss(model_train, batch, "detect", nc, None, generator, imgsz_out)[:2]


def make_train_step(model_train: nn.Module, tx: opt_lib.Transform, nc: int = 80,
                    end2end: bool = True, ema_decay: float = 0.9999, accumulate: int = 1,
                    task: str = "detect", kpt_shape=None, imgsz_out=None,
                    device_aug=None) -> Callable:
    """Build ``train_step(state, batch, generator) -> (state, metrics)``.

    ``batch``: img (B, H, W, 3) uint8 (normalised on the device) or float
    in [0, 1]; cls (B, M) ints (classify: (B,)); bboxes (B, M, 4) xyxy in
    image units; mask (B, M) bool; segment adds masks (B, M, Hm, Wm), pose
    kpts (B, M, K, 3) in image pixels, obb rboxes (B, M, 5) xywhr; each with
    a leading dimension of ``accumulate`` when it is above 1.
    ``generator`` draws the stochastic-depth masks, microbatch after
    microbatch.  ``imgsz_out`` (a multi-scale bucket) resizes each
    microbatch's images bilinearly on their device and scales its geometry
    (:func:`rescale_task_batch`), as JAX's step does.  ``kpt_shape`` is pose's
    (K, nd), (17, 3) by default.  metrics holds the loss (summed over the
    microbatches) and the box, cls and dfl items (of the last) as 0-d
    tensors; ``train_step.terms`` the task's own terms of the last
    microbatch (:func:`task_loss`).
    """
    if not end2end:
        raise NotImplementedError("train step with end2end=False is not ported "
                                  "(ROADMAP Queue 1 item 7)")
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; expected one of {sorted(TASKS)}")
    if device_aug:
        raise NotImplementedError("train step with device_aug is not ported "
                                  "(ROADMAP Queue 1 item 12)")

    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None = None):
        params = list(state.params.values())
        micro = [batch] if accumulate == 1 else [{k: v[j] for k, v in batch.items()}
                                                 for j in range(accumulate)]
        loss, grads = None, None
        for mb in micro:
            if task == "detect":
                (mb_loss, items), terms = detect_loss(model_train, mb, nc, generator,
                                                      imgsz_out), {}
            else:
                mb_loss, items, terms = task_loss(model_train, mb, task, nc, kpt_shape,
                                                  generator, imgsz_out)
            mb_grads = torch.autograd.grad(mb_loss, params)
            if grads is None:
                loss, grads = mb_loss.detach(), list(mb_grads)
            else:
                loss = loss + mb_loss.detach()
                torch._foreach_add_(grads, mb_grads)
        updates, state.opt_state = tx.update(list(grads), state.opt_state, params)
        with torch.no_grad():
            torch._foreach_add_(params, updates)
            state.ema = opt_lib.ema_update(state.ema, params, decay=ema_decay)
        state.step += 1
        train_step.terms = {k: v.detach() for k, v in terms.items()}
        metrics = {"loss": loss, "box_loss": items.box.detach(),
                   "cls_loss": items.cls.detach(), "dfl_loss": items.dfl.detach()}
        return state, metrics

    train_step.terms = {}
    return train_step


def detect_trainer(cfg="vil-det-192.yaml", device: str | torch.device = "cuda",
                   compute_dtype: torch.dtype | None = torch.bfloat16,
                   generator: torch.Generator | None = None, chunkwise_kernel: str = "auto",
                   **optimizer_kw):
    """The training entry point: the detector of ``cfg`` in train mode on
    ``device`` (the GPU unless the caller passes ``device="cpu"``), its
    mLSTM cells on ``chunkwise_kernel`` (``"auto"``: the v2 kernels), float32
    parameters with ``compute_dtype`` activations, its optimizer
    (``optimizer_kw`` go to :func:`opt_lib.build_optimizer`; the name
    defaults to AdEMAMix), the state and
    the step.  Returns ``(model, state, train_step)``."""
    model, d = build_detection_model(cfg, compute_dtype=compute_dtype, device=device,
                                     generator=generator, training=True,
                                     chunkwise_kernel=chunkwise_kernel)
    tx, _, _ = opt_lib.build_optimizer(optimizer_leaves(model),
                                       **{"name": "AdEMAMix", **optimizer_kw})
    state = TrainState.create(model, tx)
    return model, state, make_train_step(model, tx, nc=int(d.get("nc", 80)))
