"""Classification predictor (counterpart of
``xlstm_yolo_tpu/models/yolo/classify/predict.py``): the letterboxed frame
of ``BasePredictor``, as JAX's (not the reference's centre crop), and the
head's softmax as ``Results.probs``."""

from __future__ import annotations

import torch

from xlstm_yolo_tpu_torch.engine.predictor import BasePredictor
from xlstm_yolo_tpu_torch.engine.results import Probs, Results


class ClassificationPredictor(BasePredictor):
    @torch.inference_mode()
    def forward(self, img_u8: torch.Tensor):
        probs, _ = self.model(img_u8.float() / 255.0)
        return (probs,)

    def postprocess(self, preds, im0s, paths):
        (probs_b,) = preds
        results = []
        for i, im0 in enumerate(im0s):
            r = Results(im0, str(paths[i]), self.names)
            r.probs = Probs(probs_b[i])
            results.append(r)
        return results
