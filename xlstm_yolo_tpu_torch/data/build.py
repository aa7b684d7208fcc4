"""Dataset and loader construction (counterpart of ``build_yolo_dataset``,
``DataLoader`` and ``build_dataloader`` in ``xlstm_yolo_tpu/data/build.py``).

The loaders are ``torch.utils.data.DataLoader``: their worker processes
decode images, parse labels and, in train mode, draw the augmentation and
move the labels (numpy, never CUDA).  They are spawned, not forked, as the
calling process runs CUDA's and PyTorch's threads; each starts by
importing torch and the package.

The val loader takes the samples in order, the last batch short.  The
train loader (:class:`TrainLoader`) is JAX's: each epoch shuffles the
indices with ``random.Random(seed + epoch)``, drops the last partial batch,
and batch ``bi`` draws all its samples, in order, from its own
``random.Random((seed + epoch) * 9973 + bi)``, so that a batch does not
depend on which worker made it.  A batch is one item of the torch loader:
the sampler yields ``(epoch, bi, indices, mosaic_enabled)``, so the
trainer's ``close_mosaic`` switch reaches the persistent workers with the
next epoch's batches.  Sharding over processes is not ported.
"""

from __future__ import annotations

import random
import time

import torch

from xlstm_yolo_tpu_torch.data.dataset import YOLODataset


def build_yolo_dataset(cfg, img_path: str, mode: str = "val") -> YOLODataset:
    """The dataset of ``img_path``.  ``cfg`` is a dict with the val keys
    ``imgsz``, ``max_targets`` and ``single_cls`` (val), or the train config
    (a namespace; train: its augmentation keys, ``cache`` and ``fraction``
    too)."""
    get = cfg.get if isinstance(cfg, dict) else lambda k, d=None: getattr(cfg, k, d)
    train = mode == "train"
    return YOLODataset(img_path=img_path, imgsz=int(get("imgsz")), augment=train,
                       hyp=cfg if train else None,
                       max_targets=int(get("max_targets") or 128),
                       single_cls=bool(get("single_cls", False)),
                       cache=get("cache", False) if train else False,
                       fraction=float(get("fraction", 1.0) or 1.0) if train else 1.0)


def _spawn(workers: int) -> dict:
    return {"num_workers": workers, "multiprocessing_context": "spawn" if workers else None}


def build_dataloader(dataset: YOLODataset, batch: int, workers: int,
                     persistent: bool = False) -> torch.utils.data.DataLoader:
    """Batches of ``dataset.collate``d samples in order, the last one short,
    from ``workers`` worker processes (0: in the calling process), kept
    between epochs with ``persistent``."""
    workers = max(0, int(workers))
    return torch.utils.data.DataLoader(dataset, batch_size=batch, shuffle=False, drop_last=False,
                                       collate_fn=dataset.collate,
                                       persistent_workers=persistent and workers > 0,
                                       **_spawn(workers))


class _EpochBatches(torch.utils.data.Sampler):
    """The loader's items for its current epoch."""

    def __init__(self, loader: "TrainLoader"):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        ld = self.loader
        tf = ld.dataset.transforms
        enabled = bool(tf.mosaic_enabled) if tf is not None else True
        for bi, idxs in enumerate(ld.batches(ld.epoch)):
            yield ld.epoch, bi, idxs, enabled


class _BatchMaker(torch.utils.data.Dataset):
    """Makes one collated train batch per item, in a worker."""

    def __init__(self, dataset: YOLODataset, seed: int):
        self.dataset, self.seed = dataset, seed

    def __getitem__(self, item) -> dict:
        epoch, bi, idxs, mosaic_enabled = item
        t = time.perf_counter()
        if self.dataset.transforms is not None:
            self.dataset.transforms.mosaic_enabled = mosaic_enabled
        rng = random.Random((self.seed + epoch) * 9973 + bi)
        batch = self.dataset.collate([self.dataset.get_sample(i, rng) for i in idxs])
        batch["load_s"] = time.perf_counter() - t  # decode, draws and labels
        return batch


def _as_is(batch):
    return batch


class TrainLoader:
    """Epochs of shuffled, padded, collated train batches (JAX's
    ``DataLoader``), made by ``workers`` spawned processes that persist
    until :meth:`close` (0: in the calling process)."""

    def __init__(self, dataset: YOLODataset, batch_size: int = 16, shuffle: bool = True,
                 workers: int = 8, seed: int = 0, drop_last: bool = True):
        self.dataset, self.batch_size, self.shuffle = dataset, batch_size, shuffle
        self.seed, self.drop_last = seed, drop_last
        self.epoch = 0
        workers = max(0, int(workers))
        self._loader = torch.utils.data.DataLoader(
            _BatchMaker(dataset, seed), batch_size=None, sampler=_EpochBatches(self),
            collate_fn=_as_is, persistent_workers=workers > 0, **_spawn(workers))

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> list[int]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + epoch).shuffle(idx)
        if self.drop_last:
            idx = idx[: len(idx) - len(idx) % self.batch_size]
        return idx

    def batches(self, epoch: int) -> list[list[int]]:
        idx = self._epoch_indices(epoch)
        bs = self.batch_size
        return [idx[i:i + bs] for i in range(0, len(idx), bs)]

    def iter_epoch(self, epoch: int):
        """The batches of ``epoch``, in order."""
        self.epoch = epoch
        yield from self._loader

    def close(self):
        """Stop the worker processes."""
        stop_workers(self._loader)


def stop_workers(loader: torch.utils.data.DataLoader):
    """Stop the persistent worker processes of ``loader``, if it has any."""
    it = getattr(loader, "_iterator", None)
    loader._iterator = None
    if it is not None and hasattr(it, "_shutdown_workers"):
        it._shutdown_workers()
