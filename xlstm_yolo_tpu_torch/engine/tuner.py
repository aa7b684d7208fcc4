"""Mutation-based hyperparameter evolution, and the Ray Tune gate.

Counterpart of ``xlstm_yolo_tpu/engine/tuner.py``: the same search space,
the same mutation (``random.Random(seed)`` gives JAX's children), the same
``tune_results.csv`` and ``best_hyperparameters.yaml``; each generation
trains through the port's ``DetectionTrainer`` on ``device`` (the GPU
unless the caller asks for the CPU).  A generation that raises scores 0,
as in JAX, and its exception is also written to an ``error`` column of
``tune_results.csv`` (JAX only prints it), so a failed kernel cannot pass
for a poor set of hyperparameters.
"""

from __future__ import annotations

import csv
import random
import shutil
from pathlib import Path

import numpy as np
import torch

# (min, max, gain) per hyperparameter
SPACE = {
    "lr0": (1e-5, 1e-1, 1.0),
    "lrf": (0.01, 1.0, 1.0),
    "momentum": (0.6, 0.98, 0.3),
    "weight_decay": (0.0, 0.001, 1.0),
    "warmup_epochs": (0.0, 5.0, 1.0),
    "box": (0.02, 0.2, 1.0),
    "cls": (0.2, 4.0, 1.0),
    "dfl": (0.4, 6.0, 1.0),
    "hsv_h": (0.0, 0.1, 1.0),
    "hsv_s": (0.0, 0.9, 1.0),
    "hsv_v": (0.0, 0.9, 1.0),
    "degrees": (0.0, 45.0, 1.0),
    "translate": (0.0, 0.9, 1.0),
    "scale": (0.0, 0.9, 1.0),
    "shear": (0.0, 10.0, 1.0),
    "perspective": (0.0, 0.001, 1.0),
    "flipud": (0.0, 1.0, 1.0),
    "fliplr": (0.0, 1.0, 1.0),
    "mosaic": (0.0, 1.0, 1.0),
    "mixup": (0.0, 1.0, 1.0),
}


class Tuner:
    def __init__(self, args: dict, save_dir: str | Path = "runs/tune",
                 device: str | torch.device | None = None):
        self.base_args = dict(args)
        self.device = device
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.csv = self.save_dir / "tune_results.csv"

    def _mutate(self, parent: dict, rng: random.Random, mutation: float = 0.8,
                sigma: float = 0.2) -> dict:
        child = dict(parent)
        while True:
            changed = False
            for k, (lo, hi, gain) in SPACE.items():
                if rng.random() < mutation:
                    v = float(parent.get(k, (lo + hi) / 2))
                    v *= 1 + rng.gauss(0, sigma) * gain
                    child[k] = float(np.clip(v, lo, hi))
                    changed = True
            if changed:
                return child

    def __call__(self, model_cfg: str, data: str, iterations: int = 10,
                 epochs_per_iter: int = 5, seed: int = 0):
        """Train ``iterations`` generations of ``epochs_per_iter`` epochs, each
        from the best hyperparameters so far mutated (the first unmutated);
        returns (best hyperparameters, best fitness)."""
        from xlstm_yolo_tpu_torch.engine.trainer import DetectionTrainer

        rng = random.Random(seed)
        best_fit, best_hyp = -1.0, {k: self.base_args.get(k) for k in SPACE if k in self.base_args}
        history = []

        for gen in range(iterations):
            hyp = self._mutate(best_hyp, rng) if gen > 0 else dict(best_hyp)
            overrides = {**self.base_args, **hyp,
                         "data": data, "epochs": epochs_per_iter,
                         "project": str(self.save_dir), "name": f"gen{gen}",
                         "exist_ok": True, "val": True, "plots": False}
            error = None
            try:
                trainer = DetectionTrainer(overrides=overrides, model_cfg=model_cfg,
                                           device=self.device)
                metrics = trainer.train()
                fit = float(metrics.get("fitness", 0.0))
            except Exception as e:  # a bad mutation must not end the search
                error = f"{type(e).__name__}: {e}"
                print(f"tune gen{gen} failed: {error}")
                fit = 0.0
            history.append({"gen": gen, "fitness": fit, **hyp,
                            **({"error": error} if error else {})})
            if fit > best_fit:
                best_fit, best_hyp = fit, hyp
                results = self.save_dir / f"gen{gen}" / "results.csv"
                if results.exists():
                    shutil.copy(results, self.save_dir / "best_results.csv")
            self._log(history)
            print(f"tune gen{gen}: fitness={fit:.4f} best={best_fit:.4f}")

        (self.save_dir / "best_hyperparameters.yaml").write_text(
            "\n".join(f"{k}: {v}" for k, v in best_hyp.items())
        )
        return best_hyp, best_fit

    def _log(self, history):
        # union of keys: gen0 logs only the inherited hyps, mutated gens
        # log the full space, a failed gen its error
        fields = list(dict.fromkeys(k for row in history for k in row))
        with open(self.csv, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=fields, restval="")
            w.writeheader()
            w.writerows(history)


# -- Ray Tune (JAX's gate: Ray is optional and not installed here) --

TASK2METRIC = {
    "detect": "metrics/mAP50-95(B)",
    "segment": "metrics/mAP50-95(M)",
    "pose": "metrics/mAP50-95(P)",
    "obb": "metrics/mAP50-95(B)",
    "classify": "metrics/accuracy_top1",
}


def ray_tune_space():
    """The default search space as plain (low, high) bounds, turned into
    ``tune.uniform`` only when Ray is importable."""
    return {k: (lo, hi) for k, (lo, hi, _gain) in SPACE.items()} | {
        "warmup_momentum": (0.0, 0.95),
        "copy_paste": (0.0, 1.0),
    }


def run_ray_tune(model, space: dict | None = None, grace_period: int = 10,
                 gpu_per_trial: int | None = None, max_samples: int = 10,
                 **train_args):
    """Hyperparameter search via Ray Tune and ASHA over the task's metric,
    each trial ``model.train(**config)``; without Ray it raises JAX's
    ModuleNotFoundError."""
    try:
        import ray
        from ray import tune
        from ray.air import RunConfig
        from ray.tune.schedulers import ASHAScheduler
    except ImportError:
        raise ModuleNotFoundError(
            'Ray Tune required but not found. To install run: pip install "ray[tune]"'
        )

    task = getattr(model, "task", "detect")
    space = space or {k: tune.uniform(lo, hi)
                      for k, (lo, hi) in ray_tune_space().items()}
    data = train_args.get("data")
    if data:
        space["data"] = data

    model_in_store = ray.put(model)

    def _tune(config):
        m = ray.get(model_in_store)
        config.update(train_args)
        return m.train(**config)

    trainable = tune.with_resources(
        _tune, {"cpu": 8, "gpu": gpu_per_trial or 0})
    scheduler = ASHAScheduler(
        time_attr="epoch", metric=TASK2METRIC.get(task, TASK2METRIC["detect"]),
        mode="max", max_t=train_args.get("epochs") or 100,
        grace_period=grace_period, reduction_factor=3)
    tune_dir = Path(train_args.pop("save_dir", "runs/tune_ray")).resolve()
    tune_dir.mkdir(parents=True, exist_ok=True)
    tuner = tune.Tuner(
        trainable, param_space=space,
        tune_config=tune.TuneConfig(scheduler=scheduler,
                                    num_samples=max_samples),
        run_config=RunConfig(storage_path=str(tune_dir)))
    tuner.fit()
    results = tuner.get_results()
    ray.shutdown()
    return results
