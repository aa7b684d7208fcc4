"""OBB predictor (counterpart of ``xlstm_yolo_tpu/models/yolo/obb/predict.py``):
rotated NMS over probiou on the device; on the host the centres lose the
letterbox padding and gain, the extents the gain (the angle is unchanged by
an aspect-preserving resize)."""

from __future__ import annotations

import torch

from xlstm_yolo_tpu_torch.engine.predictor import BasePredictor
from xlstm_yolo_tpu_torch.engine.results import OBB, Results
from xlstm_yolo_tpu_torch.models.yolo.segment.predict import nms_args
from xlstm_yolo_tpu_torch.utils import ops


@torch.inference_mode()
def forward(model: torch.nn.Module, img_u8: torch.Tensor, nms: dict):
    """The OBB model and rotated NMS on the device -> (detections (B,
    max_det, 7) [xywhr, conf, cls], valid (B, max_det))."""
    y, _ = model(img_u8.float() / 255.0)
    return ops.non_max_suppression_rotated(y, **nms)


class OBBPredictor(BasePredictor):
    def forward(self, img_u8: torch.Tensor):
        return forward(self.model, img_u8, nms_args(self.args))

    def postprocess(self, preds, im0s, paths):
        dets_b, ok_b = preds
        results = []
        for i, im0 in enumerate(im0s):
            det = dets_b[i][ok_b[i]].copy()
            if len(det):
                gain, (px, py) = ops._gain_pad((self.imgsz, self.imgsz), im0.shape[:2], None)
                det[:, 0] = (det[:, 0] - px) / gain
                det[:, 1] = (det[:, 1] - py) / gain
                det[:, 2:4] /= gain
            r = Results(im0, str(paths[i]), self.names)
            r.obb = OBB(det, im0.shape[:2])
            results.append(r)
        return results
