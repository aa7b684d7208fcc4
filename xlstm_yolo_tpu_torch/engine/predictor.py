"""Predictor: source loader -> device letterbox -> model forward -> Results.

Counterpart of ``BasePredictor`` / ``DetectionPredictor`` in
``xlstm_yolo_tpu/engine/predictor.py``.  The source goes through
``data.loaders.load_inference_source`` (image files, directories, globs,
numpy arrays, PIL-like images, tensors; JAX's dispatch and batches).
Frames are letterboxed to the square model input on the model's device,
and the last incomplete batch is padded to the first batch's size, as the
JAX predictor does.  ``augment=True`` runs ``nn.tasks.predict_augment``
(the plain forward for the end2end heads of the shipped detectors; other
heads' merged anchors go through ``utils.ops.non_max_suppression``).
``speed["preprocess"]`` counts the file decoding and the letterbox.  A task
predictor's ``forward`` returns a tuple (detections and the head's extras,
``models/yolo/*/predict.py``), which comes to the host whole, as JAX's
predictor passes it (JAX ``engine/predictor.py:123-125``).
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

from xlstm_yolo_tpu_torch.cfg import PREDICT_DEFAULTS
from xlstm_yolo_tpu_torch.data.augment import LetterBox
from xlstm_yolo_tpu_torch.data.loaders import load_inference_source
from xlstm_yolo_tpu_torch.engine.results import Results
from xlstm_yolo_tpu_torch.nn.tasks import predict_augment
from xlstm_yolo_tpu_torch.utils import ops
from xlstm_yolo_tpu_torch.utils.torch_utils import to_host


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
        x = img_u8.float() / 255.0
        if not self.args["augment"]:
            return self.model(x)[0]
        y, _aux = predict_augment(self.model, x)
        if y.shape[-1] != 6:  # anchor-level (B, A, 4+nc): NMS
            out, ok = ops.non_max_suppression(
                y, conf_thres=self.args["conf"] if self.args["conf"] is not None else 0.25,
                iou_thres=self.args["iou"] or 0.7, max_det=int(self.args["max_det"] or 300),
                nc=y.shape[-1] - 4)
            y = torch.where(ok[..., None], out, torch.zeros_like(out))
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
            results.append(Results(im0, str(paths[i]), self.names).update(
                np.concatenate([boxes, det[:, 4:6]], axis=1)))
        return results

    def stream_inference(self, source) -> Iterator[Results]:
        self.dataset = dataset = load_inference_source(
            source, batch=int(self.args["batch"] or 1), vid_stride=int(self.args["vid_stride"] or 1))
        first_bs = None
        decoded = getattr(dataset, "decode_s", 0.0)
        for paths, im0s, _infos in dataset:
            decode_s = getattr(dataset, "decode_s", 0.0) - decoded
            t0 = time.perf_counter()
            batch = self.preprocess(im0s)
            n = batch.shape[0]
            first_bs = first_bs or n
            if n < first_bs:  # pad the tail batch to the first batch's size
                batch = torch.cat([batch, batch.new_zeros((first_bs - n, *batch.shape[1:]))])
            t1 = time.perf_counter()
            out = self.forward(batch)
            preds = to_host(out, n)
            t2 = time.perf_counter()
            results = self.postprocess(preds, im0s, paths)
            t3 = time.perf_counter()
            for r in results:
                r.speed = {"preprocess": (t1 - t0 + decode_s) / n * 1e3,
                           "inference": (t2 - t1) / n * 1e3,
                           "postprocess": (t3 - t2) / n * 1e3}
                self.seen += 1
                yield r
            decoded = getattr(dataset, "decode_s", 0.0)

    def __call__(self, source=None, stream: bool = False):
        if stream:
            return self.stream_inference(source)
        return list(self.stream_inference(source))


class DetectionPredictor(BasePredictor):
    """Detect-task predictor."""
