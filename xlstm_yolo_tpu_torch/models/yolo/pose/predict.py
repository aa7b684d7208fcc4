"""Pose predictor (counterpart of ``xlstm_yolo_tpu/models/yolo/pose/predict.py``):
NMS and the gather of the kept anchors' decoded keypoints on the device,
the keypoints mapped back to the original image on the host."""

from __future__ import annotations

import numpy as np
import torch

from xlstm_yolo_tpu_torch.engine.predictor import BasePredictor
from xlstm_yolo_tpu_torch.engine.results import Keypoints, Results
from xlstm_yolo_tpu_torch.models.yolo.segment.predict import nms_args, nms_gather
from xlstm_yolo_tpu_torch.utils import ops


@torch.inference_mode()
def forward(model: torch.nn.Module, img_u8: torch.Tensor, nms: dict, kpt_shape):
    """The pose model and NMS on the device -> (detections (B, max_det, 6),
    valid (B, max_det), keypoints (B, max_det, K * nd))."""
    y, _ = model(img_u8.float() / 255.0)
    return nms_gather(y, kpt_shape[0] * kpt_shape[1], nms)


class PosePredictor(BasePredictor):
    def __init__(self, cfg: dict, model: torch.nn.Module, names: dict):
        super().__init__(cfg, model, names)
        self.kpt_shape = tuple(model.model[-1].kpt_shape)

    def forward(self, img_u8: torch.Tensor):
        return forward(self.model, img_u8, nms_args(self.args), self.kpt_shape)

    def postprocess(self, preds, im0s, paths):
        dets_b, ok_b, kpts_b = preds
        K, nd = self.kpt_shape
        results = []
        for i, im0 in enumerate(im0s):
            det = dets_b[i][ok_b[i]]
            kp = kpts_b[i][ok_b[i]].reshape(-1, K, nd)
            sz = (self.imgsz, self.imgsz)
            boxes = ops.scale_boxes(sz, det[:, :4].copy(), im0.shape[:2])
            if len(kp):
                xy = ops.scale_boxes(sz, np.concatenate([kp[..., :2].reshape(-1, 2)] * 2, -1),
                                     im0.shape[:2])[:, :2].reshape(-1, K, 2)
                kp = np.concatenate([xy, kp[..., 2:]], -1) if nd == 3 else xy
            r = Results(im0, str(paths[i]), self.names).update(
                np.concatenate([boxes, det[:, 4:6]], axis=1))
            if len(kp):
                r.keypoints = Keypoints(kp, im0.shape[:2])
            results.append(r)
        return results
