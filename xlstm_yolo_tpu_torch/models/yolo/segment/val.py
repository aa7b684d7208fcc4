"""Segmentation validator: box and mask mAP (counterpart of
``xlstm_yolo_tpu/models/yolo/segment/val.py``).

On the device: the forward, NMS, the gather of the kept anchors' mask
coefficients, and each image's masks at prototype resolution
(``utils.ops.process_mask``: logit > 0 inside the box).  On the host, as
JAX's: the masks, resized to the ground truth's grid with OpenCV's
INTER_NEAREST where the grids differ (``utils.cv.resize_nearest``), are
matched to the dataset's masks by mask IoU, the boxes by box IoU, at the
10 thresholds of the detect validator.
"""

from __future__ import annotations

import numpy as np
import torch

from xlstm_yolo_tpu_torch.engine.validator import DetectionValidator, match_predictions
from xlstm_yolo_tpu_torch.models.yolo.segment.predict import forward
from xlstm_yolo_tpu_torch.utils import ops
from xlstm_yolo_tpu_torch.utils.cv import resize_nearest
from xlstm_yolo_tpu_torch.utils.metrics import SegmentMetrics, box_iou_matrix, mask_iou


def stats_arrays(stats: dict, keys) -> list[np.ndarray]:
    """The per-image lists of ``stats`` concatenated (empty where none)."""
    empty = {"tp": np.zeros((0, 10), bool), "tp_m": np.zeros((0, 10), bool),
             "tp_p": np.zeros((0, 10), bool)}
    return [np.concatenate(stats[k]) if stats[k] else empty.get(k, np.zeros((0,)))
            for k in keys]


def native_boxes(det: np.ndarray, batch: dict, i: int, imgsz: int):
    """(predicted xyxy, gt xyxy, gt classes) of image i in its original frame."""
    orig_shape, ratio_pad = batch["orig_shape"][i], batch["ratio_pad"][i]
    sz = (imgsz, imgsz)
    boxes = ops.scale_boxes(sz, det[:, :4].copy(), orig_shape, ratio_pad=ratio_pad)
    m = batch["mask"][i]
    gt_lb, gt_cls = batch["bboxes"][i][m], batch["cls"][i][m]
    gt = (ops.scale_boxes(sz, gt_lb, orig_shape, ratio_pad=ratio_pad) if len(gt_lb)
          else gt_lb.reshape(0, 4))
    return boxes, gt, gt_cls


def box_tp(det: np.ndarray, boxes: np.ndarray, gt: np.ndarray, gt_cls: np.ndarray):
    iou = (box_iou_matrix(gt, boxes) if len(det) and len(gt)
           else np.zeros((len(gt), len(det))))
    return match_predictions(det[:, 5], gt_cls, iou)


class SegmentationValidator(DetectionValidator):
    task = "segment"

    def __init__(self, cfg: dict, keep_loader: bool = False):
        super().__init__(cfg, keep_loader)
        self.metrics = SegmentMetrics(names=self.names)

    def forward(self, model: torch.nn.Module, img_u8: torch.Tensor):
        return forward(model, img_u8, self.nms)

    @torch.inference_mode()
    def forward_masks(self, model: torch.nn.Module, img_u8: torch.Tensor):
        """-> (detections, valid, the kept detections' masks of all images
        (sum of k_i, Hm, Wm) bool, k_i per image): each image's detections
        of a class below the dataset's ``nc``, assembled on the device."""
        dets, ok, coeffs, proto = self.forward(model, img_u8)
        keep = ok & (dets[..., 5] < self.nc)
        masks = [ops.process_mask(proto[i], coeffs[i][keep[i]], dets[i][keep[i]][:, :4],
                                  img_u8.shape[1:3]) for i in range(len(dets))]
        counts = torch.tensor([len(m) for m in masks])
        return dets, ok, torch.cat(masks), counts

    def __call__(self, model: torch.nn.Module) -> dict:
        imgsz = int(self.args["imgsz"])
        stats = {k: [] for k in ("tp", "tp_m", "conf", "pred_cls", "target_cls")}
        for batch, n, (dets_b, ok_b, masks, counts) in self.batches(model, self.forward_masks):
            ends = np.cumsum(counts)
            for i in range(n):
                det = dets_b[i][ok_b[i]]
                det = det[det[:, 5] < self.nc]
                boxes, gt, gt_cls = native_boxes(det, batch, i, imgsz)
                tp = box_tp(det, boxes, gt, gt_cls)
                gt_masks = batch["masks"][i][batch["mask"][i]]
                if len(det) and len(gt_masks):
                    pred = masks[ends[i] - len(det):ends[i]]
                    if pred.shape[1:] != gt_masks.shape[1:]:
                        pred = np.stack([resize_nearest(p.astype(np.uint8), *gt_masks.shape[:0:-1])
                                         for p in pred]).astype(bool)
                    iou_m = mask_iou(gt_masks.reshape(len(gt_masks), -1).astype(np.float32),
                                     pred.reshape(len(pred), -1).astype(np.float32))
                else:
                    iou_m = np.zeros((len(gt_masks), len(det)))
                stats["tp"].append(tp)
                stats["tp_m"].append(match_predictions(det[:, 5], gt_cls, iou_m))
                stats["conf"].append(det[:, 4])
                stats["pred_cls"].append(det[:, 5])
                stats["target_cls"].append(gt_cls)
        tp, tp_m, conf, pred_cls, target_cls = stats_arrays(
            stats, ("tp", "tp_m", "conf", "pred_cls", "target_cls"))
        if tp.size and target_cls.size:
            self.metrics.process(tp, tp_m, conf, pred_cls, target_cls)
        r = self.metrics
        print(f"val(seg): images={self.seen} box mAP50={r.box.map50:.4f} "
              f"mAP50-95={r.box.map:.4f} mask mAP50={r.seg.map50:.4f} "
              f"mAP50-95={r.seg.map:.4f} ({self.speed['inference']:.1f}ms/img)")
        return self.metrics.results_dict
