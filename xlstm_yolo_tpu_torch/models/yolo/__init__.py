"""YOLO task plugins: each task's trainer, validator and predictor
(``model.task_map``)."""

from xlstm_yolo_tpu_torch.models.yolo.model import task_map  # noqa: F401
