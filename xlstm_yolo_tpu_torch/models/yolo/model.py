"""Task registry: each task's trainer, validator and predictor.

Counterpart of ``task_map`` in ``xlstm_yolo_tpu/models/yolo/model.py``,
entry for entry: the facade's ``val`` of segment and pose runs the detect
validator (box metrics), as JAX's does; ``SegmentationValidator`` and
``PoseValidator`` are reached directly (the trainer validates each task
with its own).  Every trainer is ``DetectionTrainer``, which trains the
train config's ``task``.
"""

from xlstm_yolo_tpu_torch.models.yolo.classify.predict import ClassificationPredictor
from xlstm_yolo_tpu_torch.models.yolo.classify.val import ClassificationValidator
from xlstm_yolo_tpu_torch.models.yolo.detect import (
    DetectionPredictor,
    DetectionTrainer,
    DetectionValidator,
)
from xlstm_yolo_tpu_torch.models.yolo.obb.predict import OBBPredictor
from xlstm_yolo_tpu_torch.models.yolo.obb.val import OBBValidator
from xlstm_yolo_tpu_torch.models.yolo.pose.predict import PosePredictor
from xlstm_yolo_tpu_torch.models.yolo.segment.predict import SegmentationPredictor

task_map = {
    "detect": {"trainer": DetectionTrainer, "validator": DetectionValidator,
               "predictor": DetectionPredictor},
    "segment": {"trainer": DetectionTrainer, "validator": DetectionValidator,
                "predictor": SegmentationPredictor},
    "pose": {"trainer": DetectionTrainer, "validator": DetectionValidator,
             "predictor": PosePredictor},
    "obb": {"trainer": DetectionTrainer, "validator": OBBValidator, "predictor": OBBPredictor},
    "classify": {"trainer": DetectionTrainer, "validator": ClassificationValidator,
                 "predictor": ClassificationPredictor},
}
