"""The detect task's triple."""

from xlstm_yolo_tpu_torch.engine.predictor import DetectionPredictor  # noqa: F401
from xlstm_yolo_tpu_torch.engine.trainer import DetectionTrainer  # noqa: F401
from xlstm_yolo_tpu_torch.engine.validator import DetectionValidator  # noqa: F401
