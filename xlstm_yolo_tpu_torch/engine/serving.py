"""Throughput serving: ``scan`` batches a CUDA graph replay, fed by a thread.

Counterpart of ``xlstm_yolo_tpu/engine/serving.py:25-81``, where
``ThroughputEngine`` folds ``scan`` batches into one XLA program and feeds
the next group from a background thread.  On CUDA that one program is a
CUDA graph:

- a graph is captured that runs ``predict`` on each of the ``scan`` batches
  of a static device buffer (scan, B, H, W, C) uint8, for each of two such
  buffers; a group replays the graph of its buffer, once;
- a feeder thread stacks group k+1 into pinned host memory and copies it
  into the other buffer on a copy stream while group k replays; events
  order the copy after the last replay that read that buffer, and the
  replay after its copy;
- a tail shorter than ``scan`` replays a single-batch graph per batch;
- outputs come back to pinned memory and are yielded per batch, in order,
  as float32 numpy arrays, one group behind the device.

``predict`` maps one uint8 batch to one tensor and runs under
``torch.no_grad``; it must be capturable (no host reads of device values,
no pageable copies).  A capture that fails raises: there is no eager
fallback.  On the CPU (``device="cpu"``) a plain loop runs.  The batches
of one call must have the first one's shape; the graphs are kept per batch
shape, so a later call with another shape captures its own.  ``replays``
counts the replays of each kind.
"""

from __future__ import annotations

import itertools
import queue
import threading
from types import SimpleNamespace
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from xlstm_yolo_tpu_torch.utils.torch_utils import select_device

__all__ = ["ThroughputEngine"]


class ThroughputEngine:
    def __init__(self, predict: Callable[[torch.Tensor], torch.Tensor], scan: int = 8,
                 device: str | torch.device = "cuda"):
        self.predict = predict
        self.scan = int(scan)
        self.device = select_device(device)
        self.replays = {"group": 0, "single": 0}
        self._grp: dict[tuple, SimpleNamespace] = {}  # shape -> group graphs, buffers, events
        self._single: dict[tuple, tuple] = {}  # shape -> single-batch graph, input, output

    def __call__(self, batches: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Yield ``predict``'s output for each batch of ``batches`` (equally
        shaped uint8 (B, H, W, C) arrays), in order."""
        if self.device.type != "cuda":
            return self._plain(batches)
        return self._graphed(batches)

    # -- CPU -----------------------------------------------------------------
    def _plain(self, batches):
        with torch.no_grad():
            for b in batches:
                yield self.predict(torch.from_numpy(np.asarray(b)).to(self.device)).float().numpy()

    # -- CUDA ----------------------------------------------------------------
    @staticmethod
    def _check(b, shape: tuple) -> np.ndarray:
        b = np.ascontiguousarray(b)
        if b.dtype != np.uint8 or b.ndim != 4:
            raise ValueError(f"expected uint8 (B, H, W, C) batches, got {b.dtype} {b.shape}")
        if b.shape != shape:
            raise ValueError(f"batch of shape {b.shape} in a call whose first batch is {shape}")
        return b

    @staticmethod
    def _capture(fn: Callable[[], torch.Tensor], pool):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
        return graph, out

    def _warm_up(self, x: torch.Tensor) -> None:
        """Eager calls on a side stream before capture (lazy initialisation,
        library handles), as ``torch.cuda.graph`` asks."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self.predict(x)
        torch.cuda.current_stream(self.device).wait_stream(side)

    def _group_fn(self, buf: torch.Tensor):
        return lambda: torch.stack([self.predict(buf[i]).float() for i in range(self.scan)])

    def _graphed(self, batches) -> Iterator[np.ndarray]:
        it = iter(batches)
        head = list(itertools.islice(it, self.scan))
        if not head:
            return
        shape = tuple(np.shape(head[0]))
        head = [self._check(b, shape) for b in head]
        with torch.no_grad(), torch.cuda.device(self.device):
            if len(head) == self.scan:
                yield from self._groups(head, it, shape)
            else:
                yield from self._tail(head, shape)

    def _group_graphs(self, shape: tuple) -> SimpleNamespace:
        """The two input buffers, their graphs and the copy stream and events,
        made at the first group of this batch shape and kept."""
        if shape in self._grp:
            return self._grp[shape]
        dev, shape_in = self.device, (self.scan, *shape)
        dev_in = [torch.zeros(shape_in, dtype=torch.uint8, device=dev) for _ in range(2)]
        self._warm_up(dev_in[0][0])
        pool = torch.cuda.graph_pool_handle()
        graphs, dev_out = zip(*(self._capture(self._group_fn(b), pool) for b in dev_in))
        self._grp[shape] = SimpleNamespace(
            dev_in=dev_in, graphs=graphs, dev_out=dev_out,
            host_in=[torch.empty(shape_in, dtype=torch.uint8).pin_memory() for _ in range(2)],
            host_out=[torch.empty(o.shape, dtype=o.dtype).pin_memory() for o in dev_out],
            copy=torch.cuda.Stream(dev), ready=[torch.cuda.Event() for _ in range(2)],
            free=[torch.cuda.Event() for _ in range(2)], done=[torch.cuda.Event() for _ in range(2)])
        return self._grp[shape]

    def _groups(self, head, it, shape) -> Iterator[np.ndarray]:
        dev, scan = self.device, self.scan
        grp = self._group_graphs(shape)
        dev_in, host_in, graphs, dev_out, host_out = (grp.dev_in, grp.host_in, grp.graphs,
                                                      grp.dev_out, grp.host_out)
        copy, ready, free, done = grp.copy, grp.ready, grp.free, grp.done
        q_ready: queue.Queue = queue.Queue()
        q_free: queue.Queue = queue.Queue()
        stop = threading.Event()

        def stage(slot: int, group: list) -> None:
            ready[slot].synchronize()  # the last copy out of this pinned buffer is done
            np.stack(group, out=host_in[slot].numpy())
            with torch.cuda.stream(copy):
                copy.wait_event(free[slot])  # the last replay that read dev_in[slot]
                dev_in[slot].copy_(host_in[slot], non_blocking=True)
                ready[slot].record(copy)

        def feeder() -> None:
            try:
                group = []
                for b in it:
                    group.append(self._check(b, shape))
                    if len(group) == scan:
                        slot = q_free.get()
                        if stop.is_set():
                            return
                        stage(slot, group)
                        q_ready.put(("group", slot))
                        group = []
                q_ready.put(("tail", group))
            except BaseException as exc:  # re-raised in the consumer
                q_ready.put(("error", exc))

        stage(0, head)
        q_ready.put(("group", 0))
        q_free.put(1)
        thread = threading.Thread(target=feeder, daemon=True)
        thread.start()
        cur = torch.cuda.current_stream(dev)
        prev = None
        tail = []
        try:
            while True:
                kind, val = q_ready.get()
                if kind == "error":
                    raise val
                if kind == "tail":
                    tail = val
                    break
                slot = val
                cur.wait_event(ready[slot])
                graphs[slot].replay()
                self.replays["group"] += 1
                free[slot].record(cur)
                host_out[slot].copy_(dev_out[slot], non_blocking=True)
                done[slot].record(cur)
                q_free.put(slot)
                if prev is not None:
                    yield from self._emit(done[prev], host_out[prev])
                prev = slot
            if prev is not None:
                yield from self._emit(done[prev], host_out[prev])
        finally:
            stop.set()
            q_free.put(0)  # wake a feeder waiting for a buffer
            thread.join()
        if tail:
            yield from self._tail(tail, shape)

    @staticmethod
    def _emit(done: torch.cuda.Event, host: torch.Tensor) -> Iterator[np.ndarray]:
        done.synchronize()
        for row in host.numpy():
            yield row.copy()

    def _tail(self, batches: list, shape: tuple) -> Iterator[np.ndarray]:
        if shape not in self._single:
            x = torch.zeros(shape, dtype=torch.uint8, device=self.device)
            self._warm_up(x)
            self._single[shape] = (x, *self._capture(lambda: self.predict(x).float(), None))
        x, graph, out = self._single[shape]
        for b in batches:
            x.copy_(torch.from_numpy(b))
            graph.replay()
            self.replays["single"] += 1
            yield out.cpu().numpy()
