"""Dataset and loader construction (counterpart of ``build_yolo_dataset``
and ``build_dataloader`` in ``xlstm_yolo_tpu/data/build.py``), val mode.

The loader is ``torch.utils.data.DataLoader``: its worker processes decode
images and parse labels only (numpy, never CUDA).  They are spawned, not
forked, as the calling process runs CUDA's and PyTorch's threads; each
starts by importing torch and the package.  Training's shuffled loader and
sharding over processes are not ported.
"""

from __future__ import annotations

import torch

from xlstm_yolo_tpu_torch.data.dataset import YOLODataset


def build_yolo_dataset(cfg: dict, img_path: str) -> YOLODataset:
    """The val dataset of ``img_path`` with the val keys ``imgsz``,
    ``max_targets`` and ``single_cls`` of ``cfg``."""
    return YOLODataset(img_path=img_path, imgsz=int(cfg["imgsz"]),
                       max_targets=int(cfg.get("max_targets") or 128),
                       single_cls=bool(cfg.get("single_cls", False)))


def build_dataloader(dataset: YOLODataset, batch: int, workers: int) -> torch.utils.data.DataLoader:
    """Batches of ``dataset.collate``d samples in order, the last one short,
    from ``workers`` worker processes (0: in the calling process)."""
    workers = max(0, int(workers))
    return torch.utils.data.DataLoader(dataset, batch_size=batch, shuffle=False, drop_last=False,
                                       num_workers=workers, collate_fn=dataset.collate,
                                       multiprocessing_context="spawn" if workers else None)
