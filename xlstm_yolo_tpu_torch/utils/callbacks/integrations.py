"""Third-party logger integrations (counterparts of
``xlstm_yolo_tpu/utils/callbacks/integrations.py``).

Each integration is import-guarded: where its package is absent,
registration is a no-op that returns False.  The trainer passed to every
hook exposes ``.metrics`` (dict), ``.epoch``, ``.save_dir``, ``.wdir`` and
``.args``.
"""

from __future__ import annotations

from xlstm_yolo_tpu_torch.utils.callbacks import Callbacks


def _epoch_metrics(trainer) -> dict:
    out = {"epoch": int(getattr(trainer, "epoch", 0))}
    for k, v in (getattr(trainer, "metrics", None) or {}).items():
        try:
            out[k.replace("(", "_").replace(")", "_")] = float(v)
        except (TypeError, ValueError):
            pass
    return out


def add_wandb(callbacks: Callbacks, project: str | None = None):
    """Weights & Biases."""
    try:
        import wandb
    except ImportError:
        return False

    def on_train_start(trainer):
        if wandb.run is None:
            wandb.init(project=project or str(getattr(trainer.args, "project", None) or "xlstm-yolo-tpu"),
                       name=str(getattr(trainer.args, "name", None) or None),
                       config=vars(trainer.args))

    def on_fit_epoch_end(trainer):
        wandb.log(_epoch_metrics(trainer), step=trainer.epoch)

    def on_train_end(trainer):
        wdir = getattr(trainer, "wdir", None)
        if wdir is not None and (wdir / "best.pt").exists():
            art = wandb.Artifact(f"run_{wandb.run.id}_model", type="model")
            art.add_file(str(wdir / "best.pt"))
            wandb.run.log_artifact(art, aliases=["best"])
        wandb.run.finish()

    callbacks.add("on_train_start", on_train_start)
    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    callbacks.add("on_train_end", on_train_end)
    return True


def add_mlflow(callbacks: Callbacks, experiment: str | None = None):
    """MLflow."""
    try:
        import mlflow
    except ImportError:
        return False

    def on_train_start(trainer):
        if experiment:
            mlflow.set_experiment(experiment)
        mlflow.start_run(run_name=str(getattr(trainer.args, "name", None) or None))
        mlflow.log_params({k: str(v) for k, v in vars(trainer.args).items()})

    def on_fit_epoch_end(trainer):
        mlflow.log_metrics(_epoch_metrics(trainer), step=trainer.epoch)

    def on_train_end(trainer):
        wdir = getattr(trainer, "wdir", None)
        if wdir is not None and wdir.exists():
            mlflow.log_artifacts(str(wdir), artifact_path="weights")
        mlflow.end_run()

    callbacks.add("on_train_start", on_train_start)
    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    callbacks.add("on_train_end", on_train_end)
    return True


def add_clearml(callbacks: Callbacks, project: str | None = None):
    """ClearML."""
    try:
        from clearml import Task
    except ImportError:
        return False

    state = {}

    def on_train_start(trainer):
        state["task"] = Task.init(
            project_name=project or "xlstm-yolo-tpu",
            task_name=str(getattr(trainer.args, "name", None) or "train"),
        )
        state["task"].connect(vars(trainer.args))

    def on_fit_epoch_end(trainer):
        logger = state["task"].get_logger()
        for k, v in _epoch_metrics(trainer).items():
            logger.report_scalar("metrics", k, v, trainer.epoch)

    callbacks.add("on_train_start", on_train_start)
    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    return True


def add_comet(callbacks: Callbacks, project: str | None = None):
    """Comet."""
    try:
        import comet_ml
    except ImportError:
        return False

    state = {}

    def on_train_start(trainer):
        state["exp"] = comet_ml.Experiment(project_name=project or "xlstm-yolo-tpu")
        state["exp"].log_parameters(vars(trainer.args))

    def on_fit_epoch_end(trainer):
        state["exp"].log_metrics(_epoch_metrics(trainer), epoch=trainer.epoch)

    def on_train_end(trainer):
        state["exp"].end()

    callbacks.add("on_train_start", on_train_start)
    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    callbacks.add("on_train_end", on_train_end)
    return True


def add_dvclive(callbacks: Callbacks):
    """DVCLive."""
    try:
        from dvclive import Live
    except ImportError:
        return False

    state = {}

    def on_train_start(trainer):
        state["live"] = Live(save_dvc_exp=True)

    def on_fit_epoch_end(trainer):
        live = state["live"]
        for k, v in _epoch_metrics(trainer).items():
            live.log_metric(k, v)
        live.next_step()

    def on_train_end(trainer):
        state["live"].end()

    callbacks.add("on_train_start", on_train_start)
    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    callbacks.add("on_train_end", on_train_end)
    return True


def add_neptune(callbacks: Callbacks, project: str | None = None):
    """Neptune."""
    try:
        import neptune
    except ImportError:
        return False

    state = {}

    def on_train_start(trainer):
        state["run"] = neptune.init_run(project=project)
        state["run"]["config"] = {k: str(v) for k, v in vars(trainer.args).items()}

    def on_fit_epoch_end(trainer):
        for k, v in _epoch_metrics(trainer).items():
            state["run"][f"metrics/{k}"].append(v)

    callbacks.add("on_train_start", on_train_start)
    callbacks.add("on_fit_epoch_end", on_fit_epoch_end)
    return True


INTEGRATIONS = {
    "wandb": add_wandb,
    "mlflow": add_mlflow,
    "clearml": add_clearml,
    "comet": add_comet,
    "dvc": add_dvclive,
    "neptune": add_neptune,
}


def add_available_integrations(callbacks: Callbacks) -> list[str]:
    """Register every integration whose package is importable; returns
    the names that attached."""
    return [name for name, fn in INTEGRATIONS.items() if fn(callbacks)]
