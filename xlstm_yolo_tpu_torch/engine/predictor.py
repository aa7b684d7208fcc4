"""Predictor: device letterbox -> model forward -> Results.

Counterpart of ``BasePredictor`` / ``DetectionPredictor`` in
``xlstm_yolo_tpu/engine/predictor.py``.  The source is one uint8 HWC BGR
numpy image or a list of them (file and video decoding are not ported
yet).  Frames are letterboxed to the square model input on the model's
device, and the last incomplete batch is padded to the first batch's
size, as the JAX predictor does.
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

from xlstm_yolo_tpu_torch.cfg import PREDICT_DEFAULTS
from xlstm_yolo_tpu_torch.data.augment import LetterBox
from xlstm_yolo_tpu_torch.engine.results import Results
from xlstm_yolo_tpu_torch.utils import ops


class BasePredictor:
    """Streaming inference loop."""

    def __init__(self, cfg: dict, model: torch.nn.Module, names: dict):
        self.args = {**PREDICT_DEFAULTS, **cfg}
        self.model = model
        self.names = names
        self.device = next(model.parameters()).device
        self.imgsz = int(self.args["imgsz"])
        self.letterbox = LetterBox((self.imgsz, self.imgsz), auto=False, scaleup=True)
        self.seen = 0

    @torch.inference_mode()
    def forward(self, img_u8: torch.Tensor) -> torch.Tensor:
        """(B, imgsz, imgsz, 3) uint8 RGB on the model's device ->
        (B, max_det, 6) [xyxy at model scale, conf, cls]."""
        y, _aux = self.model(img_u8.float() / 255.0)
        return y

    def preprocess(self, im_list: list[np.ndarray]) -> torch.Tensor:
        out = []
        for im in im_list:
            t = torch.from_numpy(np.ascontiguousarray(im)).to(self.device)
            lb, _ratio, _pad = self.letterbox(t)
            out.append(lb.flip(-1))  # BGR -> RGB
        return torch.stack(out)

    def postprocess(self, preds: np.ndarray, im0s: list[np.ndarray], paths: list[str]):
        conf = self.args["conf"] if self.args["conf"] is not None else 0.25
        classes = self.args["classes"]
        results = []
        for i, im0 in enumerate(im0s):
            det = preds[i][: int(self.args["max_det"])]
            det = det[det[:, 4] > conf]
            if classes:
                det = det[np.isin(det[:, 5].astype(int), list(classes))]
            boxes = ops.scale_boxes((self.imgsz, self.imgsz), det[:, :4], im0.shape[:2])
            results.append(Results(im0, paths[i], self.names).update(
                np.concatenate([boxes, det[:, 4:6]], axis=1)))
        return results

    def stream_inference(self, source) -> Iterator[Results]:
        ims = [source] if isinstance(source, np.ndarray) else list(source)
        bs = int(self.args["batch"])
        first_bs = None
        for start in range(0, len(ims), bs):
            im0s = ims[start:start + bs]
            paths = [f"image{start + j}" for j in range(len(im0s))]
            t0 = time.perf_counter()
            batch = self.preprocess(im0s)
            n = batch.shape[0]
            first_bs = first_bs or n
            if n < first_bs:  # pad the tail batch to the first batch's size
                batch = torch.cat([batch, batch.new_zeros((first_bs - n, *batch.shape[1:]))])
            t1 = time.perf_counter()
            preds = self.forward(batch)[:n].float().cpu().numpy()
            t2 = time.perf_counter()
            results = self.postprocess(preds, im0s, paths)
            t3 = time.perf_counter()
            for r in results:
                r.speed = {"preprocess": (t1 - t0) / n * 1e3,
                           "inference": (t2 - t1) / n * 1e3,
                           "postprocess": (t3 - t2) / n * 1e3}
                self.seen += 1
                yield r

    def __call__(self, source=None, stream: bool = False):
        if stream:
            return self.stream_inference(source)
        return list(self.stream_inference(source))


class DetectionPredictor(BasePredictor):
    """Detect-task predictor."""
