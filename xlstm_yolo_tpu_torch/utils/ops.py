"""Letterbox inverse for boxes (counterpart of ``clip_boxes`` /
``scale_boxes`` in ``xlstm_yolo_tpu/utils/ops.py``), on host numpy arrays."""

from __future__ import annotations

import numpy as np


def clip_boxes(boxes: np.ndarray, shape) -> np.ndarray:
    """Clip xyxy boxes to an image of shape (h, w, ...)."""
    h, w = shape[:2]
    return np.stack([np.clip(boxes[..., 0], 0, w), np.clip(boxes[..., 1], 0, h),
                     np.clip(boxes[..., 2], 0, w), np.clip(boxes[..., 3], 0, h)], axis=-1)


def scale_boxes(img1_shape, boxes: np.ndarray, img0_shape, ratio_pad=None,
                padding: bool = True) -> np.ndarray:
    """Rescale xyxy boxes from the letterboxed img1 back to the original img0."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = (round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1),
               round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1))
    else:
        gain, pad = ratio_pad[0][0], ratio_pad[1]
    if padding:
        boxes = boxes - np.asarray([pad[0], pad[1], pad[0], pad[1]], dtype=boxes.dtype)
    return clip_boxes(boxes / gain, img0_shape)
