"""``python -m xlstm_yolo_tpu_torch.cfg [task] mode key=value ...``: the CLI."""

from xlstm_yolo_tpu_torch.cfg import entrypoint

if __name__ == "__main__":
    entrypoint()
