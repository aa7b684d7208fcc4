"""IoU of boxes and the detection metrics (counterpart of ``bbox_iou``,
``box_iou_matrix``, ``compute_ap``, ``smooth``, ``ap_per_class``,
``DetMetrics`` and ``ConfusionMatrix`` in ``xlstm_yolo_tpu/utils/metrics.py``).

``bbox_iou`` is torch (the loss); the rest is numpy on the host, as in the
JAX package and the reference, and gives the JAX package's numbers bit for
bit on the same inputs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has only trapz


def bbox_iou(box1, box2, xywh: bool = True, kind: str = "iou", eps: float = 1e-7):
    """Elementwise IoU / GIoU / DIoU / CIoU of broadcastable (..., 4) boxes.

    The CIoU aspect term's weight alpha is taken without gradient, as in
    the JAX package (and the CIoU paper's implementation).
    """
    if xywh:
        x1, y1, w1, h1 = box1.chunk(4, dim=-1)
        x2, y2, w2, h2 = box2.chunk(4, dim=-1)
        b1_x1, b1_x2, b1_y1, b1_y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
        b2_x1, b2_x2, b2_y1, b2_y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.chunk(4, dim=-1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.chunk(4, dim=-1)
        w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
        w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps

    inter = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0) * (
        torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if kind == "iou":
        return iou.squeeze(-1)
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if kind == "giou":
        c_area = cw * ch + eps
        return (iou - (c_area - union) / c_area).squeeze(-1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    if kind == "diou":
        return (iou - rho2 / c2).squeeze(-1)
    if kind != "ciou":
        raise ValueError(f"unknown IoU kind {kind!r}")
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return (iou - (rho2 / c2 + v * alpha)).squeeze(-1)


def box_iou_matrix(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """IoU matrix (N, M) of xyxy boxes (N, 4) and (M, 4)."""
    a1 = box1[:, None, :2]
    a2 = box1[:, None, 2:]
    b1 = box2[None, :, :2]
    b2 = box2[None, :, 2:]
    inter = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None).prod(2)
    area1 = (box1[:, 2:] - box1[:, :2]).prod(1)
    area2 = (box2[:, 2:] - box2[:, :2]).prod(1)
    return inter / (area1[:, None] + area2[None] - inter + eps)


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP: (ap, precision envelope, recall)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box filter over a fraction ``f`` of ``y``, ends padded."""
    nf = round(len(y) * f * 2) // 2 + 1  # odd element count
    p = np.ones(nf // 2)
    yp = np.concatenate([p * y[0], y, p * y[-1]])
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray, eps: float = 1e-16):
    """Per-class AP at the 10 IoU thresholds of ``tp`` (N, 10).

    Returns the tp/fp counts at the max-F1 confidence, p, r, f1, ap (nc,
    10), the present class ids and the curves (x, p/r/f1 confidence curves,
    101-point precision at IoU 0.5).
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    x = np.linspace(0, 1, 1000)
    prec_values = np.zeros((nc, 101))

    for ci, c in enumerate(unique_classes):
        mask = pred_cls == c
        n_l = nt[ci]
        n_p = mask.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[mask]).cumsum(0)
        tpc = tp[mask].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-x, -conf[mask], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-x, -conf[mask], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if j == 0:
                prec_values[ci] = np.interp(np.linspace(0, 1, 101), mrec, mpre)

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1_curve.mean(0), 0.1).argmax()
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    tp_count = (r * nt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    curves = (x, p_curve, r_curve, f1_curve, prec_values)
    return tp_count, fp_count, p, r, f1, ap, unique_classes.astype(int), curves


@dataclass
class DetMetrics:
    """mAP bookkeeping of the detect task."""

    names: dict = field(default_factory=dict)
    p: np.ndarray = field(default_factory=lambda: np.array([]))
    r: np.ndarray = field(default_factory=lambda: np.array([]))
    f1: np.ndarray = field(default_factory=lambda: np.array([]))
    all_ap: np.ndarray = field(default_factory=lambda: np.zeros((0, 10)))
    ap_class_index: np.ndarray = field(default_factory=lambda: np.array([], dtype=int))
    nt_per_class: np.ndarray = field(default_factory=lambda: np.array([], dtype=int))
    # (x(1000), p_curve, r_curve, f1_curve (nc, 1000), prec_values (nc, 101))
    curves_results: tuple | None = None

    def process(self, tp, conf, pred_cls, target_cls):
        res = ap_per_class(tp, conf, pred_cls, target_cls)
        (_, _, self.p, self.r, self.f1, self.all_ap, self.ap_class_index,
         self.curves_results) = res
        nc = len(self.names) or (int(target_cls.max()) + 1 if len(target_cls) else 0)
        self.nt_per_class = np.bincount(np.asarray(target_cls, int), minlength=nc)

    @property
    def ap50(self):
        return self.all_ap[:, 0] if len(self.all_ap) else []

    @property
    def ap(self):
        return self.all_ap.mean(1) if len(self.all_ap) else []

    @property
    def mp(self):
        return self.p.mean() if len(self.p) else 0.0

    @property
    def mr(self):
        return self.r.mean() if len(self.r) else 0.0

    @property
    def map50(self):
        return self.all_ap[:, 0].mean() if len(self.all_ap) else 0.0

    @property
    def map75(self):
        return self.all_ap[:, 5].mean() if len(self.all_ap) else 0.0

    @property
    def map(self):
        return self.all_ap.mean() if len(self.all_ap) else 0.0

    def mean_results(self):
        return [self.mp, self.mr, self.map50, self.map]

    @property
    def fitness(self):
        """0.1 * mAP50 + 0.9 * mAP50-95."""
        return 0.1 * self.map50 + 0.9 * self.map

    @property
    def results_dict(self):
        return {
            "metrics/precision(B)": self.mp,
            "metrics/recall(B)": self.mr,
            "metrics/mAP50(B)": self.map50,
            "metrics/mAP50-95(B)": self.map,
            "fitness": self.fitness,
        }


class ConfusionMatrix:
    """Detection confusion matrix, (nc + 1) x (nc + 1): [predicted, true],
    the last row and column the background."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1), dtype=np.int64)

    def process_batch(self, detections: np.ndarray, gt_bboxes: np.ndarray, gt_cls: np.ndarray):
        """detections: (N, 6) [xyxy, conf, cls]; gts xyxy + class ids."""
        if gt_cls.size == 0:
            if detections is not None and len(detections):
                for dc in detections[detections[:, 4] > self.conf][:, 5].astype(int):
                    self.matrix[dc, self.nc] += 1  # false positive
            return
        if detections is None or len(detections) == 0:
            for gc in gt_cls.astype(int):
                self.matrix[self.nc, gc] += 1  # missed
            return

        detections = detections[detections[:, 4] > self.conf]
        gt_classes = gt_cls.astype(int)
        det_classes = detections[:, 5].astype(int)
        iou = box_iou_matrix(gt_bboxes, detections[:, :4])

        x = np.where(iou > self.iou_thres)
        if x[0].size:
            matches = np.concatenate((np.stack(x, 1), iou[x][:, None]), 1)
            if x[0].size > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))

        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j]], gc] += 1  # correct
            else:
                self.matrix[self.nc, gc] += 1  # background FN
        for i, dc in enumerate(det_classes):
            if not (n and (m1 == i).any()):
                self.matrix[dc, self.nc] += 1  # background FP
