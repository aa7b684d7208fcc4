"""The trainer of every task: epochs, warmup, accumulation, EMA validation,
checkpoints and resume.

Counterpart of ``_prefetch``, ``EarlyStopping`` and ``DetectionTrainer``
in ``xlstm_yolo_tpu/engine/trainer.py``, line by line where the two agree.
The task (the train config's ``task``: detect, segment, pose, obb or
classify) flows as in JAX: into the dataset (a YOLO-format set and its
YAML, whose ``kpt_shape`` builds the pose head and whose ``flip_idx`` swaps
the flipped keypoints; classify: the folder of ``train/`` and ``val/``
class folders), the step's loss (``steps.make_train_step(task=...)``), the
batch keys moved to the device (segment's ``masks``, pose's ``kpts``,
OBB's ``rboxes``) and the validator (``DetectionValidator``,
``SegmentationValidator``, ``PoseValidator``, ``OBBValidator`` or
``ClassificationValidator``, whose ``fitness`` picks ``best.pt``).  The
layers of a step, from the host down:

- the loader's spawned workers (``data/build.TrainLoader``) decode the
  image files, draw the augmentation and move the labels; each batch is a
  list of recipes, the decoded tiles (classify: the crops) and the padded
  labels and task targets;
- a thread (``_prefetch``) gathers ``accumulate`` loader batches per
  optimizer step;
- the main process composes each batch's pixels on the device
  (``pixels.compose_batch``) and runs the step (``steps.make_train_step``:
  the microbatches' forwards and backwards through the training kernels,
  then one clip, update and EMA update);
- each epoch the EMA parameters and the BatchNorm statistics are copied
  into an eval twin of the model (``training=False``) and validated with
  the task's validator (the inference kernel); ``results.csv`` gets a
  row, and ``weights/last.pt`` (and ``best.pt`` when the fitness is the
  best so far) a checkpoint (``utils/checkpoint``).

At the end, ``best.pt`` is validated again and both checkpoints are
stripped to state dicts (``*_stripped.pt``).  ``resume=True`` restores
``weights/last.pt`` of the same run directory, the stochastic-depth
generator included (JAX restarts its step rng at a resume).  The schedule
is JAX's: ``accumulate = min(max(round(nbs / batch), 1), nb)``; weight
decay scaled by ``batch * accumulate / nbs``; the leftover microbatches of
an epoch dropped; ``warmup_steps = max(round(warmup_epochs * steps), max(1,
round(100 / accumulate)))``; the mosaic off from epoch ``epochs -
close_mosaic`` (at that epoch only, so never when ``epochs <
close_mosaic``, nor after a resume past it, as in JAX).

The model is trained at ``imgsz``, the YAML's or any other size at which
its grids rescale (``nn.tasks.token_grids``); its parameters do not depend
on the size.  ``multi_scale=True`` adds JAX's buckets: the sizes
``sorted({max(32, round(imgsz * s / 32) * 32) for s in (0.8, 1.0, 1.2)})``,
each a step that resizes the loader's ``imgsz`` batch on the device
(``steps.make_train_step(imgsz_out=...)``), one drawn a step with
``random.Random(seed * 1000 + epoch).choice`` as JAX draws it
(``self.buckets`` keeps the sequence; classify has none, as in JAX);
validation stays at ``imgsz``.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP item):
``device_aug`` (item 12), an orbax ``pretrained`` checkpoint (item 7).  The
trainer reads no environment variable.  A ``pretrained`` path or a ``cache`` mode given as an override
is kept (JAX's ``get_cfg``, which the port's mirrors, coerces the string
of a boolean key to False, so JAX's trainer never loads an override's
``pretrained`` file).  JAX's flat and hybrid optimizer states (``XY_FLAT_OPT``,
``XY_TP``) are not ported.  As in JAX, with ``plots`` each epoch's metrics
go to TensorBoard under ``save_dir/tb`` (``utils.callbacks.add_tensorboard``,
where the ``tensorboard`` package is installed), and the logger
integrations whose packages import register themselves
(``utils.callbacks.integrations``), but only when the user's settings
allow it (``SETTINGS["sync"]``, False by default: ``yolo-tpu-torch settings
sync=True``); JAX registers them whenever their package imports, and a
service's ``init`` may reach the network.  The plots are not ported
(ROADMAP Queue 1 item 6); the trainer says so once.
"""

from __future__ import annotations

import copy
import csv
import queue
import random
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from xlstm_yolo_tpu_torch import utils
from xlstm_yolo_tpu_torch.cfg import VAL_DEFAULTS, get_cfg
from xlstm_yolo_tpu_torch.data.build import TrainLoader, build_yolo_dataset
from xlstm_yolo_tpu_torch.data.dataset import ClassificationDataset, check_det_dataset
from xlstm_yolo_tpu_torch.engine import optimizers as opt_lib
from xlstm_yolo_tpu_torch.engine.steps import TrainState, make_train_step, optimizer_leaves
from xlstm_yolo_tpu_torch.engine.validator import DetectionValidator
from xlstm_yolo_tpu_torch.nn.tasks import build_detection_model
from xlstm_yolo_tpu_torch.utils.callbacks import Callbacks, add_tensorboard
from xlstm_yolo_tpu_torch.utils.callbacks.integrations import add_available_integrations
from xlstm_yolo_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    read_checkpoint,
    save_checkpoint,
    strip_optimizer,
)
from xlstm_yolo_tpu_torch.utils.torch_utils import select_device

_SENTINEL = object()
_TASK_KEYS = ("masks", "kpts", "rboxes")  # segment's, pose's and OBB's targets


def task_validator(task: str, cfg: dict):
    """The validator of ``task`` on the val keys ``cfg``, its loader kept
    between epochs (classify's reads its folder anew each call)."""
    from xlstm_yolo_tpu_torch.models.yolo.classify.val import ClassificationValidator
    from xlstm_yolo_tpu_torch.models.yolo.obb.val import OBBValidator
    from xlstm_yolo_tpu_torch.models.yolo.pose.val import PoseValidator
    from xlstm_yolo_tpu_torch.models.yolo.segment.val import SegmentationValidator

    if task == "classify":
        return ClassificationValidator(cfg)
    return {"detect": DetectionValidator, "segment": SegmentationValidator,
            "pose": PoseValidator, "obb": OBBValidator}[task](cfg, keep_loader=True)


def _prefetch(gen, depth: int = 2):
    """Run ``gen`` on a background thread, buffering ``depth`` items;
    exceptions re-raise in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []

    def worker():
        try:
            for item in gen:
                q.put(item)
        except BaseException as e:  # re-raised on the main thread
            err.append(e)
        finally:
            q.put(_SENTINEL)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item


class EarlyStopping:
    """Stop when the fitness has not improved for ``patience`` epochs."""

    def __init__(self, patience: int = 100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness is None:
            return False
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        return (epoch - self.best_epoch) >= self.patience


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported (ROADMAP Queue 1 item {item})")


class DetectionTrainer:
    """The trainer of ``args.task`` on ``device`` (the GPU unless the caller
    asks for the CPU).  ``self.timing`` holds, per epoch, the seconds the loop
    waited on the loader, composed pixels and stepped, and the workers'
    seconds per image."""

    def __init__(self, cfg=None, overrides: dict | None = None, model_cfg=None,
                 device: str | torch.device | None = None):
        self.args = cfg if isinstance(cfg, SimpleNamespace) else get_cfg(cfg, overrides)
        for k in ("pretrained", "cache"):  # get_cfg coerces a boolean key's string to False
            v = (overrides or {}).get(k)
            if isinstance(v, str) and v.lower() not in ("true", "false"):
                setattr(self.args, k, v)
        self.model_cfg = model_cfg or self.args.model
        self.device = select_device(device or self.args.device or "cuda")
        self.callbacks = Callbacks()
        self.save_dir = self._get_save_dir()
        if getattr(self.args, "plots", True):
            add_tensorboard(self.callbacks, str(self.save_dir / "tb"))
            print("train: the plots are not ported (ROADMAP Queue 1 item 6)")
        if utils.SETTINGS.get("sync"):  # the remote loggers, only when the user allows them
            add_available_integrations(self.callbacks)
        self.wdir = self.save_dir / "weights"
        self.csv_path = self.save_dir / "results.csv"
        self.best_fitness = 0.0
        self.start_epoch = 0
        self.metrics = {}
        self.timing: list[dict] = []

    def _get_save_dir(self) -> Path:
        project = self.args.project or "runs/detect"
        name = self.args.name or "train"
        d = Path(project) / name
        if d.exists() and not self.args.exist_ok and not self.args.resume:
            for i in range(2, 10000):
                d2 = Path(project) / f"{name}{i}"
                if not d2.exists():
                    d = d2
                    break
        return d

    def _val_args(self, batch: int) -> dict:
        a = vars(self.args)
        keys = set(VAL_DEFAULTS) - {"save_dir", "batch", "data"}
        return {**{k: a[k] for k in keys if k in a}, "data": self.args.data, "batch": batch,
                "save_dir": str(self.save_dir)}

    # ------------------------------------------------------------------
    def train(self):
        args = self.args
        self.callbacks.run("on_pretrain_routine_start", self)
        task = str(getattr(args, "task", "detect") or "detect")
        if getattr(args, "device_aug", False):
            _refuse("device_aug", "12")
        if isinstance(args.pretrained, str) and Path(args.pretrained).suffix != ".pt":
            _refuse(f"pretrained {args.pretrained!r} (only .pt state dicts load; orbax "
                    "checkpoints)", "7")
        imgsz = int(args.imgsz)
        batch = int(args.batch)
        if task == "classify":  # a folder of train/ and val/ class folders
            root = Path(args.data)
            names = ClassificationDataset(str(root / "train"), imgsz=imgsz).names
            data = {"train": str(root / "train"), "val": str(root / "val"), "nc": len(names),
                    "names": names}
        else:
            data = check_det_dataset(args.data)
        nc = data["nc"]

        # --- model (train + eval twins) ---
        dev = self.device
        compute_dtype = torch.bfloat16 if args.amp else None
        ck = str(getattr(args, "chunkwise_kernel", "auto") or "auto")
        kpt = tuple(data["kpt_shape"]) if task == "pose" and data.get("kpt_shape") else None
        model_t, _ = build_detection_model(
            self.model_cfg, nc=nc, training=True, compute_dtype=compute_dtype, device=dev,
            generator=torch.Generator().manual_seed(int(args.seed)), chunkwise_kernel=ck,
            kpt_shape=kpt)
        model_e = copy.deepcopy(model_t).eval()  # its weights come from the EMA
        if args.pretrained and isinstance(args.pretrained, str):
            self._load_pretrained(model_t, args.pretrained)

        # --- data ---
        if task == "classify":
            trainset = ClassificationDataset(
                data["train"], imgsz=imgsz, augment=True, hyp=args,
                fraction=float(getattr(args, "fraction", 1.0) or 1.0))
        else:
            trainset = build_yolo_dataset(args, data["train"], mode="train", task=task,
                                          kpt_shape=data.get("kpt_shape"),
                                          flip_idx=data.get("flip_idx"))
        loader = TrainLoader(trainset, batch, shuffle=True, workers=int(args.workers),
                             seed=int(args.seed))
        nb = max(len(loader), 1)  # batches per epoch
        epochs = int(args.epochs)

        # --- optimizer (nbs accumulation and lr scaling) ---
        nbs = int(args.nbs)
        accumulate = min(max(round(nbs / batch), 1), nb)
        weight_decay = float(args.weight_decay) * batch * accumulate / nbs
        steps_per_epoch = max(nb // accumulate, 1)
        iterations = steps_per_epoch * epochs
        warmup_steps = max(round(float(args.warmup_epochs) * steps_per_epoch),
                           max(1, round(100 / accumulate)))
        sched_fn = opt_lib.cosine_lr if args.cos_lr else opt_lib.linear_lr
        schedule = sched_fn(float(args.lr0), float(args.lrf), epochs, steps_per_epoch)
        tx, _, opt_name = opt_lib.build_optimizer(
            optimizer_leaves(model_t), name=args.optimizer, lr=float(args.lr0),
            momentum=float(args.momentum), weight_decay=weight_decay, schedule=schedule,
            iterations=iterations, nc=nc, warmup_steps=warmup_steps,
            warmup_momentum=float(getattr(args, "warmup_momentum", 0.8)),
            warmup_bias_lr=float(getattr(args, "warmup_bias_lr", 0.1)))
        state = TrainState.create(model_t, tx)
        self.generator = torch.Generator().manual_seed(int(args.seed) + 1)  # stochastic depth
        if args.resume:
            state, self.start_epoch, self.best_fitness = load_checkpoint(
                self.wdir / "last.pt", state, self.generator)
        step_kw = dict(nc=nc, accumulate=accumulate, task=task,
                       kpt_shape=tuple(data.get("kpt_shape") or (17, 3)) if task == "pose"
                       else None)
        self.train_step = train_step = make_train_step(model_t, tx, **step_kw)
        self.accumulate = accumulate
        # multi-scale: one step per bucket of {0.8, 1.0, 1.2} x imgsz (stride-32
        # aligned), each resizing the batch and its geometry on the device
        ms_steps = {}
        if getattr(args, "multi_scale", False) and task != "classify":
            buckets = sorted({max(32, round(imgsz * s / 32) * 32) for s in (0.8, 1.0, 1.2)})
            ms_steps = {b: train_step if b == imgsz else make_train_step(
                model_t, tx, **step_kw, imgsz_out=b) for b in buckets}
            print(f"multi-scale buckets: {buckets}")
        self.buckets: list[int] = []

        self.validator = validator = task_validator(task, self._val_args(batch))
        stopper = EarlyStopping(int(args.patience))
        self.wdir.mkdir(parents=True, exist_ok=True)
        (self.save_dir / "args.yaml").write_text(
            "\n".join(f"{k}: {v}" for k, v in vars(args).items()))
        print(f"train: {len(trainset)} imgs, batch {batch}, {epochs} epochs, opt {opt_name}, "
              f"accumulate {accumulate}")
        self.callbacks.run("on_train_start", self)
        t_start = time.time()

        def epoch_batches(ep):
            """Optimizer-step groups of ``accumulate`` loader batches (an
            epoch's leftover microbatches are dropped)."""
            micro = []
            for host_batch in loader.iter_epoch(ep):
                micro.append(host_batch)
                if len(micro) == accumulate:
                    yield micro
                    micro = []

        try:
            for epoch in range(self.start_epoch, epochs):
                self.epoch = epoch
                self.callbacks.run("on_train_epoch_start", self)
                if epoch == epochs - int(args.close_mosaic) and trainset.transforms is not None:
                    trainset.transforms.mosaic_enabled = False

                self.losses = losses = []
                t_ep = time.time()
                tm = {"epoch": epoch, "wait_s": 0.0, "compose_s": 0.0, "step_s": 0.0,
                      "load_s": 0.0, "images": 0}
                self.step_files = []
                ms_rng = random.Random(int(args.seed) * 1000 + epoch)
                ms_keys = list(ms_steps)
                t_wait = time.perf_counter()
                for micro in _prefetch(epoch_batches(epoch)):
                    t0 = time.perf_counter()
                    tm["wait_s"] += t0 - t_wait
                    dev_batch = self._device_batch(trainset, micro, task)
                    t1 = time.perf_counter()
                    step_fn = train_step
                    if ms_keys:
                        bucket = ms_rng.choice(ms_keys)
                        self.buckets.append(bucket)
                        step_fn = ms_steps[bucket]
                    state, metrics = step_fn(state, dev_batch, self.generator)
                    losses.append(metrics)
                    self.step_files.append([f for b in micro for f in b["im_file"]])
                    self.callbacks.run("on_train_batch_end", self)
                    t_wait = time.perf_counter()
                    tm["compose_s"] += t1 - t0
                    tm["step_s"] += t_wait - t1
                    tm["load_s"] += sum(b["load_s"] for b in micro)
                    tm["images"] += sum(len(b["im_file"]) for b in micro)
                mloss = {k: float(np.mean([float(m[k]) for m in losses]))
                         for k in losses[0]} if losses else {}
                dt = time.time() - t_ep
                tm["epoch_s"] = dt
                self.timing.append(tm)
                print(f"epoch {epoch + 1}/{epochs}: loss={mloss.get('loss', float('nan')):.3f} "
                      f"box={mloss.get('box_loss', 0):.3f} cls={mloss.get('cls_loss', 0):.3f} "
                      f"dfl={mloss.get('dfl_loss', 0):.3f} ({dt:.1f}s, "
                      f"{len(losses) * batch * accumulate / max(dt, 1e-9):.1f} img/s)")

                # --- validation of the EMA ---
                fitness = None
                if args.val:
                    self._load_eval(model_e, dict(zip(state.params, state.ema.params)),
                                    state.batch_stats)
                    res = validator(model_e)
                    fitness = res.get("fitness", 0.0)
                    self.metrics = res
                self._log_csv(epoch, mloss, self.metrics)

                # --- checkpoints ---
                if args.save:
                    is_best = fitness is not None and fitness >= self.best_fitness
                    if is_best:
                        self.best_fitness = fitness
                    save_checkpoint(self.wdir / "last.pt", state, epoch, self.best_fitness,
                                    vars(args), self.generator)
                    if is_best:
                        save_checkpoint(self.wdir / "best.pt", state, epoch, self.best_fitness,
                                        vars(args), self.generator)
                self.callbacks.run("on_fit_epoch_end", self)

                if fitness is not None and stopper(epoch, fitness):
                    print(f"early stopping at epoch {epoch + 1} (patience {args.patience})")
                    break
                if args.time and (time.time() - t_start) / 3600 > float(args.time):
                    print("time budget reached")
                    break

            # final validation of the best weights, and the stripped checkpoints
            if args.save and args.val and (self.wdir / "best.pt").exists():
                best = read_checkpoint(self.wdir / "best.pt")
                self._load_eval(model_e, best["ema_params"], best["batch_stats"])
                print("validating best weights:")
                self.metrics = validator(model_e)
                for p in ("last.pt", "best.pt"):
                    if (self.wdir / p).exists():
                        strip_optimizer(self.wdir / p)
        finally:
            loader.close()
            if hasattr(validator, "close"):
                validator.close()

        self.callbacks.run("on_train_end", self)
        self.state, self.model, self.eval_model = state, model_t, model_e
        return self.metrics

    # ------------------------------------------------------------------
    def _device_batch(self, trainset, micro: list[dict], task: str = "detect") -> dict:
        """The step's batch on the device: each microbatch's pixels composed
        there and its task's label keys moved, stacked on a leading
        microbatch dimension when there are several."""
        dev = self.device
        keys = ("cls",) if task == "classify" else ("cls", "bboxes", "mask") + tuple(
            k for k in _TASK_KEYS if k in micro[0])
        mbs = [{"img": trainset.images(b, dev),
                **{k: torch.from_numpy(b[k]).to(dev) for k in keys}} for b in micro]
        if len(mbs) == 1:
            return mbs[0]
        return {k: torch.stack([mb[k] for mb in mbs]) for k in mbs[0]}

    @staticmethod
    def _load_eval(model_e, params: dict, batch_stats: dict):
        """Copy EMA parameters and BatchNorm statistics into the eval twin."""
        model_e.load_state_dict({**params, **batch_stats}, strict=True)

    def _load_pretrained(self, model, path: str):
        """Weights from a ``.pt`` state dict (``YOLO``'s loading rules), kept
        where the file has a key of the model (JAX loads non-strictly too)."""
        from xlstm_yolo_tpu_torch.engine.model import load_checkpoint_state

        sd = load_checkpoint_state(path, model)
        missing, unexpected = model.load_state_dict(sd, strict=False)
        print(f"pretrained: {len(sd) - len(unexpected)} tensors from {path} "
              f"({len(missing)} missing, {len(unexpected)} unexpected)")

    def _log_csv(self, epoch: int, mloss: dict, metrics: dict):
        """Append an epoch row; the header is pinned by the first row."""
        self.save_dir.mkdir(parents=True, exist_ok=True)
        row = {"epoch": epoch, **mloss, **(metrics or {})}
        if self.csv_path.exists():
            with open(self.csv_path, newline="") as fh:
                fields = next(csv.reader(fh), None) or list(row.keys())
        else:
            fields = list(row.keys())
            with open(self.csv_path, "w", newline="") as fh:
                csv.DictWriter(fh, fieldnames=fields).writeheader()
        with open(self.csv_path, "a", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=fields, extrasaction="ignore")
            w.writerow({k: row.get(k, "") for k in fields})
