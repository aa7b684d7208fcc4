"""OBB validator (counterpart of ``xlstm_yolo_tpu/models/yolo/obb/val.py``):
rotated NMS on the device; on the host the detections are matched to the
letterboxed ground-truth xywhr boxes by probiou (both in the letterboxed
frame, as JAX's), at the detect validator's 10 thresholds."""

from __future__ import annotations

import torch

from xlstm_yolo_tpu_torch.engine.validator import DetectionValidator, match_predictions
from xlstm_yolo_tpu_torch.models.yolo.segment.val import stats_arrays
from xlstm_yolo_tpu_torch.models.yolo.obb.predict import forward
from xlstm_yolo_tpu_torch.utils.metrics import rbox_iou_matrix


class OBBValidator(DetectionValidator):
    task = "obb"

    def forward(self, model: torch.nn.Module, img_u8: torch.Tensor):
        return forward(model, img_u8, self.nms)

    def __call__(self, model: torch.nn.Module) -> dict:
        stats = {k: [] for k in ("tp", "conf", "pred_cls", "target_cls")}
        for batch, n, (dets_b, ok_b) in self.batches(model, self.forward):
            for i in range(n):
                det = dets_b[i][ok_b[i]]
                det = det[det[:, 6] < self.nc]
                m = batch["mask"][i]
                gt_rb, gt_cls = batch["rboxes"][i][m], batch["cls"][i][m]
                iou = rbox_iou_matrix(gt_rb, det[:, :5])
                stats["tp"].append(match_predictions(det[:, 6], gt_cls, iou))
                stats["conf"].append(det[:, 5])
                stats["pred_cls"].append(det[:, 6])
                stats["target_cls"].append(gt_cls)
        tp, conf, pred_cls, target_cls = stats_arrays(stats, ("tp", "conf", "pred_cls",
                                                              "target_cls"))
        if tp.size and target_cls.size:
            self.metrics.process(tp, conf, pred_cls, target_cls)
        mp, mr, map50, map5095 = self.metrics.mean_results()
        print(f"val(obb): images={self.seen} P={mp:.3f} R={mr:.3f} mAP50={map50:.4f} "
              f"mAP50-95={map5095:.4f} ({self.speed['inference']:.1f}ms/img)")
        return self.metrics.results_dict
