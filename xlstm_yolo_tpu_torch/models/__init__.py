"""Task plugins of the port (counterpart of ``xlstm_yolo_tpu/models``: the
YOLO task families)."""
