"""Pose validator: box and OKS keypoint mAP (counterpart of
``xlstm_yolo_tpu/models/yolo/pose/val.py``): NMS and the keypoint gather on
the device; on the host the boxes and keypoints back in the original frame,
OKS with the gt box area * 0.53 (COCO's sigmas for 17 keypoints, uniform
ones otherwise), the detect validator's matching."""

from __future__ import annotations

import numpy as np
import torch

from xlstm_yolo_tpu_torch.engine.validator import DetectionValidator, match_predictions
from xlstm_yolo_tpu_torch.models.yolo.pose.predict import forward
from xlstm_yolo_tpu_torch.models.yolo.segment.val import box_tp, native_boxes, stats_arrays
from xlstm_yolo_tpu_torch.utils import ops
from xlstm_yolo_tpu_torch.utils.metrics import OKS_SIGMA, PoseMetrics, kpt_iou


class PoseValidator(DetectionValidator):
    task = "pose"

    def __init__(self, cfg: dict, keep_loader: bool = False):
        super().__init__(cfg, keep_loader)
        self.kpt_shape = tuple(self.data.get("kpt_shape") or (17, 3))
        self.metrics = PoseMetrics(names=self.names)
        K = self.kpt_shape[0]
        self.sigma = OKS_SIGMA if K == 17 else np.ones(K, np.float32) / K

    def forward(self, model: torch.nn.Module, img_u8: torch.Tensor):
        return forward(model, img_u8, self.nms, self.kpt_shape)

    def __call__(self, model: torch.nn.Module) -> dict:
        imgsz = int(self.args["imgsz"])
        sz = (imgsz, imgsz)
        K, nd = self.kpt_shape
        stats = {k: [] for k in ("tp", "tp_p", "conf", "pred_cls", "target_cls")}
        for batch, n, (dets_b, ok_b, kpts_b) in self.batches(model, self.forward):
            for i in range(n):
                det = dets_b[i][ok_b[i]]
                pk = kpts_b[i][ok_b[i]].reshape(-1, K, nd)
                cok = det[:, 5] < self.nc
                det, pk = det[cok], pk[cok]
                orig_shape, ratio_pad = batch["orig_shape"][i], batch["ratio_pad"][i]
                boxes, gt, gt_cls = native_boxes(det, batch, i, imgsz)
                pk_nat = (ops.scale_coords(sz, pk.copy(), orig_shape, ratio_pad=ratio_pad)
                          if len(pk) else pk)
                gt_k = batch["kpts"][i][batch["mask"][i]]
                gt_k = (ops.scale_coords(sz, gt_k.copy(), orig_shape, ratio_pad=ratio_pad)
                        if len(gt) else gt_k.reshape(0, K, 3))
                if len(det) and len(gt_k):
                    area = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]) * 0.53
                    iou_p = kpt_iou(gt_k, pk_nat, area, self.sigma)
                else:
                    iou_p = np.zeros((len(gt_k), len(det)))
                stats["tp"].append(box_tp(det, boxes, gt, gt_cls))
                stats["tp_p"].append(match_predictions(det[:, 5], gt_cls, iou_p))
                stats["conf"].append(det[:, 4])
                stats["pred_cls"].append(det[:, 5])
                stats["target_cls"].append(gt_cls)
        tp, tp_p, conf, pred_cls, target_cls = stats_arrays(
            stats, ("tp", "tp_p", "conf", "pred_cls", "target_cls"))
        if tp.size and target_cls.size:
            self.metrics.process(tp, tp_p, conf, pred_cls, target_cls)
        r = self.metrics
        print(f"val(pose): images={self.seen} box mAP50={r.box.map50:.4f} "
              f"mAP50-95={r.box.map:.4f} pose mAP50={r.pose.map50:.4f} "
              f"mAP50-95={r.pose.map:.4f} ({self.speed['inference']:.1f}ms/img)")
        return self.metrics.results_dict
