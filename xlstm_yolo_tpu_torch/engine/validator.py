"""Detection validator: batched inference on the model's device + mAP on
the host (counterpart of ``match_predictions``, ``DetectionValidator`` and
``coco80_to_coco91`` in ``xlstm_yolo_tpu/engine/validator.py``).

A batch is decoded and its labels parsed by the loader (host), resized,
letterboxed and flipped to RGB on the model's device
(``YOLODataset.images``), padded to the batch size when it is the last
one, and run through the model as the predictor runs it (uint8 / 255,
``torch.inference_mode``).  The (B, max_det, 6) detections come back to
the host, where each image's are cut at ``conf`` (default 0.001), at
``max_det`` and to classes below the dataset's ``nc``, mapped back to the
original image with ``ratio_pad`` (as the ground truth is), and matched at
the 10 IoU thresholds 0.5:0.95.  ``DetMetrics`` aggregates them into the
JAX validator's ``results_dict``.

A task head's anchor rows (segment, pose: the facade's ``val`` of those
tasks runs this validator, as JAX's ``task_map`` has it) first go through
NMS on their box and class columns (``decode``), so their box metrics are
those of the kept boxes.  The task validators (``models/yolo/*/val.py``)
share this class's loader and its batch loop (:meth:`batches`).

With ``plots`` the confusion matrix is computed (``confusion_matrix``); the
figures are not ported.  With ``save_json`` the detections go to
``save_dir / predictions.json`` in COCO form, evaluated by ``pycocotools``
when that package and the COCO annotations are present.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from xlstm_yolo_tpu_torch.cfg import VAL_DEFAULTS
from xlstm_yolo_tpu_torch.data.build import build_dataloader, build_yolo_dataset, stop_workers
from xlstm_yolo_tpu_torch.data.dataset import check_det_dataset
from xlstm_yolo_tpu_torch.utils import ops
from xlstm_yolo_tpu_torch.utils.metrics import ConfusionMatrix, DetMetrics, box_iou_matrix
from xlstm_yolo_tpu_torch.utils.torch_utils import to_host

IOUV = np.linspace(0.5, 0.95, 10)


def match_predictions(pred_cls: np.ndarray, true_cls: np.ndarray, iou: np.ndarray) -> np.ndarray:
    """TP table (npr, 10): greedy highest-IoU matching per threshold.

    The reference's rule exactly: one sort by IoU, descending; unique
    predictions (each keeps its best gt; the rows end up in prediction
    order); then unique gts WITHOUT sorting by IoU again, so among a gt's
    candidates the earliest prediction wins, not the best-overlapping one.
    """
    npr = pred_cls.shape[0]
    correct = np.zeros((npr, IOUV.size), dtype=bool)
    if npr == 0 or true_cls.size == 0:
        return correct
    cls_ok = true_cls[:, None] == pred_cls[None, :]
    iou = np.where(cls_ok, iou, 0.0)
    for ti, t in enumerate(IOUV):
        gt_idx, pred_idx = np.nonzero(iou >= t)
        if gt_idx.size == 0:
            continue
        m = np.stack([gt_idx, pred_idx, iou[gt_idx, pred_idx]], axis=1)
        if m.shape[0] > 1:
            m = m[m[:, 2].argsort()[::-1]]
            m = m[np.unique(m[:, 1], return_index=True)[1]]
            m = m[np.unique(m[:, 0], return_index=True)[1]]
        correct[m[:, 1].astype(int), ti] = True
    return correct


class DetectionValidator:
    """Validates a detector (``torch.nn.Module``, eval mode) on the val split
    of a YOLO-format dataset.  ``cfg`` holds keys of ``VAL_DEFAULTS``
    (``data``: a dataset YAML or dict); ``workers`` 0 loads in the calling
    process.  With ``keep_loader`` (the trainer's, which validates every
    epoch) the dataset and its worker processes are kept from one call to
    the next until :meth:`close`."""

    task = "detect"  # the dataset's label rows

    def __init__(self, cfg: dict, keep_loader: bool = False):
        unknown = set(cfg) - set(VAL_DEFAULTS)
        if unknown:
            raise KeyError(f"not val keys: {sorted(unknown)}")
        self.args = {**VAL_DEFAULTS, **cfg}
        self.data = check_det_dataset(self.args["data"])
        self.names = self.data["names"]
        self.nc = self.data["nc"]
        self.save_dir = Path(self.args["save_dir"] or "runs/val")
        self.metrics = DetMetrics(names=self.names)
        self.confusion_matrix = None
        self.jdict: list[dict] = []
        self.seen = 0
        self.speed = {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0, "metrics": 0.0}
        self.keep_loader = keep_loader
        self._kept = None

    def close(self):
        """Stop the kept loader's worker processes."""
        if self._kept is not None:
            stop_workers(self._kept[1])
        self._kept = None

    def _loader(self, bs: int, workers: int):
        if self._kept is not None:
            return self._kept
        args = self.args
        split = self.data.get(args["split"] or "val") or self.data.get("val")
        dataset = build_yolo_dataset(args, split, task=self.task,
                                     kpt_shape=self.data.get("kpt_shape"))
        loaded = (dataset, build_dataloader(dataset, bs, workers, persistent=self.keep_loader))
        if self.keep_loader:
            self._kept = loaded
        return loaded

    @torch.inference_mode()
    def forward(self, model: torch.nn.Module, img_u8: torch.Tensor) -> torch.Tensor:
        """(B, imgsz, imgsz, 3) uint8 RGB -> (B, max_det, 6) [xyxy at model
        scale, conf, cls]."""
        y, _aux = model(img_u8.float() / 255.0)
        return self.decode(model, y)

    def decode(self, model: torch.nn.Module, y: torch.Tensor) -> torch.Tensor:
        """The head's output as (B, max_det, 6) rows: the end2end head's as
        they are; a task head's (B, A, 4+nc+extra) anchor rows through NMS of
        their box and ``nc`` class columns (empty slots zeroed)."""
        layers = getattr(model, "model", None)
        head = layers[-1] if isinstance(layers, torch.nn.ModuleList) else None
        nc = getattr(head, "nc", None)
        if y.shape[-1] == 6 or nc is None or getattr(head, "end2end", True):
            return y
        out, ok = ops.non_max_suppression(y[..., :4 + nc], nc=nc, **self.nms)
        return torch.where(ok[..., None], out, torch.zeros_like(out))

    @property
    def conf_thres(self) -> float:
        return self.args["conf"] if self.args["conf"] is not None else 0.001

    @property
    def nms(self) -> dict:
        """The validators' NMS settings: conf 0.001 and IoU 0.7 where none
        is set, 300 detections."""
        return dict(conf_thres=self.conf_thres, iou_thres=self.args["iou"] or 0.7,
                    max_det=int(self.args["max_det"] or 300))

    def batches(self, model: torch.nn.Module, forward):
        """Run ``forward(model, img_u8)`` on each batch of the val split (the
        tail padded to the batch size) and yield (batch, n images, its
        outputs on the host, floats as float32); ``speed`` and ``seen`` are
        kept as :meth:`__call__` keeps them."""
        device = next(model.parameters()).device
        bs = int(self.args["batch"] or 16)
        workers = 8 if self.args["workers"] is None else int(self.args["workers"])
        dataset, loader = self._loader(bs, workers)
        t_pre = t_inf = t_post = 0.0
        seen = 0
        t0 = time.perf_counter()
        for batch in loader:
            n = len(batch["im0"])
            img = dataset.images(batch, device)
            if n < bs:
                img = torch.cat([img, img.new_zeros((bs - n, *img.shape[1:]))])
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            out = forward(model, img)
            host = to_host(out if isinstance(out, tuple) else (out,))
            t2 = time.perf_counter()
            t_pre, t_inf = t_pre + t1 - t0, t_inf + t2 - t1
            yield batch, n, host
            seen += n
            t0 = time.perf_counter()
            t_post += t0 - t2
        self.seen = seen
        per = 1e3 / max(seen, 1)
        self.speed = {"preprocess": t_pre * per, "inference": t_inf * per,
                      "postprocess": t_post * per, "metrics": 0.0}

    def __call__(self, model: torch.nn.Module) -> dict:
        args = self.args
        imgsz = int(args["imgsz"])
        conf_thres = self.conf_thres
        stats = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
        confusion = ConfusionMatrix(self.nc)
        self.jdict = []
        for batch, n, (preds,) in self.batches(model, self.forward):
            for i in range(n):
                det = preds[i]
                det = det[det[:, 4] > conf_thres]
                det = det[: int(args["max_det"] or 300)]  # the output is score-sorted
                det = det[det[:, 5] < self.nc]  # a model with more classes than the set
                orig_shape = batch["orig_shape"][i]
                ratio_pad = batch["ratio_pad"][i]
                boxes = ops.scale_boxes((imgsz, imgsz), det[:, :4], orig_shape,
                                        ratio_pad=ratio_pad)
                det = np.concatenate([boxes, det[:, 4:6]], axis=1)

                m = batch["mask"][i]
                gt_boxes_lb = batch["bboxes"][i][m]  # letterboxed px
                gt_cls = batch["cls"][i][m]
                if len(gt_boxes_lb):
                    gt_boxes = ops.scale_boxes((imgsz, imgsz), gt_boxes_lb, orig_shape,
                                               ratio_pad=ratio_pad)
                else:
                    gt_boxes = gt_boxes_lb.reshape(0, 4)

                iou = (box_iou_matrix(gt_boxes, det[:, :4]) if len(det) and len(gt_boxes)
                       else np.zeros((len(gt_boxes), len(det))))
                tp = match_predictions(det[:, 5], gt_cls, iou)
                stats["tp"].append(tp)
                stats["conf"].append(det[:, 4])
                stats["pred_cls"].append(det[:, 5])
                stats["target_cls"].append(gt_cls)
                if args["plots"]:
                    confusion.process_batch(det, gt_boxes, gt_cls)
                if args["save_json"]:
                    self._save_one_json(det, batch["im_file"][i])

        t0 = time.perf_counter()
        tp = np.concatenate(stats["tp"]) if stats["tp"] else np.zeros((0, 10), bool)
        conf = np.concatenate(stats["conf"]) if stats["conf"] else np.zeros((0,))
        pred_cls = np.concatenate(stats["pred_cls"]) if stats["pred_cls"] else np.zeros((0,))
        target_cls = (np.concatenate(stats["target_cls"]) if stats["target_cls"]
                      else np.zeros((0,)))
        if tp.size and target_cls.size:
            self.metrics.process(tp, conf, pred_cls, target_cls)
        self.speed["metrics"] = (time.perf_counter() - t0) * 1e3 / max(self.seen, 1)
        self.confusion_matrix = confusion
        if args["plots"]:
            print("val: plots are not ported; the confusion matrix is computed "
                  "(DetectionValidator.confusion_matrix)")

        if args["save_json"] and self.jdict:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            (self.save_dir / "predictions.json").write_text(json.dumps(self.jdict))
            self._coco_eval()

        mp, mr, map50, map5095 = self.metrics.mean_results()
        print(f"val: images={self.seen} P={mp:.3f} R={mr:.3f} mAP50={map50:.4f} "
              f"mAP50-95={map5095:.4f} ({self.speed['inference']:.1f}ms/img inference)")
        return self.metrics.results_dict

    def _save_one_json(self, det: np.ndarray, im_file: str):
        """COCO json rows: 91-class ids on COCO, top-left xywh."""
        stem = Path(im_file).stem
        image_id = int(stem) if stem.isnumeric() else stem
        is_coco = self.data.get("is_coco", "coco" in str(self.args["data"] or ""))
        box = det[:, :4].copy()
        box[:, 2:] -= box[:, :2]  # xyxy -> top-left xywh
        for row, b in zip(det, box):
            self.jdict.append({
                "image_id": image_id,
                "category_id": coco80_to_coco91(int(row[5])) if is_coco else int(row[5]),
                "bbox": [round(float(x), 3) for x in b],
                "score": round(float(row[4]), 5),
            })

    def _coco_eval(self):
        try:
            from pycocotools.coco import COCO
            from pycocotools.cocoeval import COCOeval
        except ImportError:
            return
        anno_path = Path(self.data.get("path", ".")) / "annotations" / "instances_val2017.json"
        if not anno_path.exists():
            return
        anno = COCO(str(anno_path))
        pred = anno.loadRes(str(self.save_dir / "predictions.json"))
        ev = COCOeval(anno, pred, "bbox")
        ev.evaluate()
        ev.accumulate()
        ev.summarize()


_COCO91 = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44,
    46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88,
    89, 90,
]


def coco80_to_coco91(c: int) -> int:
    """COCO's 80 contiguous class ids -> its 91 category ids."""
    return _COCO91[c]
