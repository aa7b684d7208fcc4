"""Segmentation predictor (counterpart of
``xlstm_yolo_tpu/models/yolo/segment/predict.py``).

On the device: the forward, NMS and the gather of the kept anchors' mask
coefficients.  On the host, as JAX's: each detection's mask is
sigmoid(coefficients . prototypes), cropped to its box on the prototype
grid, resized over the whole original image (OpenCV's float INTER_LINEAR,
``utils.cv.resize_linear_f32``; like JAX's, the letterbox padding is not
taken off first) and thresholded at 0.5.
"""

from __future__ import annotations

import numpy as np
import torch

from xlstm_yolo_tpu_torch.engine.predictor import BasePredictor
from xlstm_yolo_tpu_torch.engine.results import Masks, Results
from xlstm_yolo_tpu_torch.utils import ops
from xlstm_yolo_tpu_torch.utils.cv import resize_linear_f32


def nms_args(args: dict) -> dict:
    """The task predictors' NMS settings: JAX's defaults (conf 0.25, IoU 0.45
    where none is set, 300 detections)."""
    return dict(conf_thres=args["conf"] if args["conf"] is not None else 0.25,
                iou_thres=args["iou"] or 0.45, max_det=int(args["max_det"] or 300))


def nms_gather(y: torch.Tensor, extra: int, nms: dict):
    """NMS of (B, A, 4 + nc + extra) anchor rows on their box and class
    columns -> (detections (B, max_det, 6), valid (B, max_det), the kept
    anchors' last ``extra`` columns (B, max_det, extra))."""
    nc = y.shape[-1] - 4 - extra
    dets, ok, idx = ops.non_max_suppression(y[..., :4 + nc], nc=nc, return_idx=True, **nms)
    rest = y[..., 4 + nc:]
    return dets, ok, rest.gather(1, idx.long()[..., None].expand(-1, -1, extra))


@torch.inference_mode()
def forward(model: torch.nn.Module, img_u8: torch.Tensor, nms: dict):
    """The segment model and NMS on the device -> (detections (B, max_det,
    6), valid (B, max_det), coefficients (B, max_det, nm), prototypes (B,
    Hm, Wm, nm))."""
    y, aux = model(img_u8.float() / 255.0)
    proto = aux["proto"]
    return (*nms_gather(y, proto.shape[-1], nms), proto)


def assemble_masks(det: np.ndarray, coeff: np.ndarray, proto: np.ndarray, imgsz: int,
                   shape: tuple[int, int]) -> np.ndarray:
    """(n, h0, w0) uint8 masks of ``det``'s rows (xyxy at model scale) from
    their (n, nm) coefficients and the (Hm, Wm, nm) prototypes."""
    Hm, Wm, nm = proto.shape
    logits = coeff @ proto.reshape(-1, nm).T
    m = (1 / (1 + np.exp(-logits))).reshape(-1, Hm, Wm)
    mboxes = det[:, :4] * (np.array([Wm, Hm, Wm, Hm]) / imgsz)
    ys = np.arange(Hm)[None, :, None]
    xs = np.arange(Wm)[None, None, :]
    inside = ((xs >= mboxes[:, 0, None, None]) & (xs < mboxes[:, 2, None, None])
              & (ys >= mboxes[:, 1, None, None]) & (ys < mboxes[:, 3, None, None]))
    m = m * inside
    h0, w0 = shape
    return np.stack([resize_linear_f32(mi, w0, h0) > 0.5 for mi in m]).astype(np.uint8)


class SegmentationPredictor(BasePredictor):
    def forward(self, img_u8: torch.Tensor):
        return forward(self.model, img_u8, nms_args(self.args))

    def postprocess(self, preds, im0s, paths):
        dets_b, ok_b, coeffs_b, proto_b = preds
        results = []
        for i, im0 in enumerate(im0s):
            det, coeff = dets_b[i][ok_b[i]], coeffs_b[i][ok_b[i]]
            boxes = ops.scale_boxes((self.imgsz, self.imgsz), det[:, :4].copy(), im0.shape[:2])
            r = Results(im0, str(paths[i]), self.names).update(
                np.concatenate([boxes, det[:, 4:6]], axis=1))
            if len(det):
                r.masks = Masks(assemble_masks(det, coeff, proto_b[i], self.imgsz,
                                               im0.shape[:2]), im0.shape[:2])
            results.append(r)
        return results
