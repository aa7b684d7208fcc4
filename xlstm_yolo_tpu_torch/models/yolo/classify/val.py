"""Classification validator: top-1 and top-5 accuracy (counterpart of
``xlstm_yolo_tpu/models/yolo/classify/val.py``) over ``data/<split>``, a
folder per class (``data.dataset.ClassificationDataset``); the batch's
resize and centre crop run on the model's device."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from xlstm_yolo_tpu_torch.cfg import VAL_DEFAULTS
from xlstm_yolo_tpu_torch.data.build import build_dataloader
from xlstm_yolo_tpu_torch.data.dataset import ClassificationDataset
from xlstm_yolo_tpu_torch.utils.torch_utils import to_host


class ClassificationValidator:
    def __init__(self, cfg: dict):
        unknown = set(cfg) - set(VAL_DEFAULTS) - {"crop_fraction"}
        if unknown:
            raise KeyError(f"not val keys: {sorted(unknown)}")
        self.args = {**VAL_DEFAULTS, **cfg}
        self.seen = 0
        self.speed = {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}

    @torch.inference_mode()
    def forward(self, model: torch.nn.Module, img_u8: torch.Tensor) -> torch.Tensor:
        probs, _ = model(img_u8.float() / 255.0)
        return probs

    def __call__(self, model: torch.nn.Module) -> dict:
        device = next(model.parameters()).device
        args = self.args
        bs = int(args["batch"] or 16)
        workers = 8 if args["workers"] is None else int(args["workers"])
        dataset = ClassificationDataset(str(Path(args["data"]) / (args["split"] or "val")),
                                        imgsz=int(args["imgsz"]), hyp=args)
        top1 = top5 = seen = 0
        t_pre = t_inf = t_post = 0.0
        t0 = time.perf_counter()
        for batch in build_dataloader(dataset, bs, workers):
            n = len(batch["im0"])
            img = dataset.images(batch, device)
            if n < bs:
                img = torch.cat([img, img.new_zeros((bs - n, *img.shape[1:]))])
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            probs = to_host(self.forward(model, img), n)
            t2 = time.perf_counter()
            labels = np.asarray(batch["cls"][:n])
            order = np.argsort(-probs, axis=-1)
            top1 += int((order[:, 0] == labels).sum())
            top5 += int((order[:, :5] == labels[:, None]).any(1).sum())
            seen += n
            t3 = time.perf_counter()
            t_pre, t_inf, t_post = t_pre + t1 - t0, t_inf + t2 - t1, t_post + t3 - t2
            t0 = t3
        self.seen = seen
        per = 1e3 / max(seen, 1)
        self.speed = {"preprocess": t_pre * per, "inference": t_inf * per,
                      "postprocess": t_post * per}
        results = {"metrics/accuracy_top1": top1 / max(seen, 1),
                   "metrics/accuracy_top5": top5 / max(seen, 1),
                   "fitness": top1 / max(seen, 1)}
        print(f"val(cls): images={seen} top1={results['metrics/accuracy_top1']:.4f} "
              f"top5={results['metrics/accuracy_top5']:.4f} "
              f"({self.speed['inference']:.1f}ms/img)")
        return results
