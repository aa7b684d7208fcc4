"""Configuration of the port: the keys of the JAX package's
``cfg/default.yaml`` that the predictor and the validator read.  The model
YAMLs are in ``cfg/models``."""

PREDICT_DEFAULTS = {
    "conf": None,  # None -> 0.25
    "iou": 0.7,
    "max_det": 300,
    "imgsz": 640,
    "batch": 16,
    "classes": None,
}

VAL_DEFAULTS = {
    "data": None,  # dataset yaml
    "batch": 16,
    "imgsz": 640,
    "conf": None,  # None -> 0.001
    "iou": 0.7,  # read by no detect validator: the v10 head needs no NMS
    "max_det": 300,
    "split": "val",
    "save_json": False,
    "plots": True,  # the confusion matrix; the figures are not ported
    "workers": 8,
    "max_targets": 128,
    "single_cls": False,
    "save_dir": None,  # None -> runs/val (predictions.json with save_json)
}
