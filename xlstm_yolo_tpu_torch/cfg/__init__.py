"""Configuration of the port: the predict keys of the JAX package's
``cfg/default.yaml`` that the predictor reads.  The model YAMLs are in
``cfg/models``."""

PREDICT_DEFAULTS = {
    "conf": None,  # None -> 0.25
    "iou": 0.7,
    "max_det": 300,
    "imgsz": 640,
    "batch": 16,
    "classes": None,
}
