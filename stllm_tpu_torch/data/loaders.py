"""Loader wrappers: batching, multi-dataset scheduling, device prefetch
(stllm_tpu/data/loaders.py).

  - ``DataLoader``      : a batcher with a thread pool (decode work is C++ or
                          cv2 and releases the GIL), a bounded prefetch and a
                          ``seed + epoch`` shuffle;
  - ``MultiIterLoader`` : ratio sampling;
  - ``MetaLoader``      : a length-weighted shuffled schedule over loaders,
                          every process deriving the SAME order from a
                          shared seed;
  - ``IterLoader``      : an infinite epoch-wrapping iterator;
  - ``DevicePrefetcher``: a background thread that moves each batch to the
                          device one batch ahead (``.to(device,
                          non_blocking=True)`` from pinned memory on a CUDA
                          device). Unlike the reference's producer, which
                          ends the stream quietly when its loader raises, the
                          consumer re-raises the producer's exception.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


class DataLoader:
    """Minimal map-style loader: shuffle (``seed + epoch``), batch, collate,
    prefetch ``prefetch`` batches of futures."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = True,
        num_workers: int = 4,
        drop_last: bool = True,
        seed: int = 42,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _index_batches(self) -> List[List[int]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        batches = [
            order[i:i + self.batch_size].tolist()
            for i in range(0, n, self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        batches = self._index_batches()
        # not a context manager: an abandoned iterator would run the
        # executor's blocking shutdown inside GC (noisy on interpreter exit);
        # shut down explicitly without waiting instead
        pool = ThreadPoolExecutor(self.num_workers)
        try:
            pending = []
            bi = 0

            def submit(idxs):
                return [pool.submit(self.dataset.__getitem__, i) for i in idxs]

            while bi < len(batches) and len(pending) < self.prefetch:
                pending.append(submit(batches[bi]))
                bi += 1
            while pending:
                futures = pending.pop(0)
                samples = [f.result() for f in futures]
                if bi < len(batches):
                    pending.append(submit(batches[bi]))
                    bi += 1
                yield self.collate_fn(samples)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


class MultiIterLoader:
    """Ratio-weighted sampling over iterators."""

    def __init__(self, loaders: Sequence, ratios: Optional[Sequence[float]] = None,
                 seed: int = 0):
        for loader in loaders:
            assert hasattr(loader, "__next__"), f"{loader} has no __next__"
        if ratios is None:
            ratios = [1.0] * len(loaders)
        total = float(sum(ratios))
        self.ratios = [r / total for r in ratios]
        self.loaders = list(loaders)
        self.rng = np.random.default_rng(seed)

    def __next__(self):
        idx = int(self.rng.choice(len(self.loaders), p=self.ratios))
        return next(self.loaders[idx])


class IterLoader:
    """Infinite epoch-wrapping iterator."""

    def __init__(self, dataloader, use_distributed: bool = False):
        self._dataloader = dataloader
        self.iter_loader = iter(dataloader)
        self._use_distributed = use_distributed
        self._epoch = 0

    @property
    def epoch(self) -> int:
        return self._epoch

    def __next__(self):
        try:
            return next(self.iter_loader)
        except StopIteration:
            self._epoch += 1
            if hasattr(self._dataloader, "set_epoch"):
                self._dataloader.set_epoch(self._epoch)
            self.iter_loader = iter(self._dataloader)
            return next(self.iter_loader)

    def __iter__(self):
        return self

    def __len__(self) -> int:
        return len(self._dataloader)


class MetaLoader:
    """Length-weighted shuffled schedule over multiple loaders; every process
    derives the SAME order from ``seed`` (the same schedule without a
    collective)."""

    def __init__(self, loaders: Sequence, seed: int = 42):
        self.loaders = list(loaders)
        self.seed = seed
        self._round = 0
        self.iter_order = self._build_iter()

    def _build_iter(self) -> List[int]:
        order: List[int] = []
        for n, l in enumerate(self.loaders):
            order.extend([n] * len(l))
        rng = np.random.default_rng(self.seed + self._round)
        rng.shuffle(order)
        self._round += 1
        return order

    def __len__(self) -> int:
        return len(self.iter_order)

    def __iter__(self):
        """Runs indefinitely, reshuffling each pass."""
        while True:
            for loader_idx in self.iter_order:
                yield next(self.loaders[loader_idx])
            self.iter_order = self._build_iter()


class DevicePrefetcher:
    """Moves batches to ``device`` (default: the CUDA card) on a background
    thread, ``depth`` batches ahead. ``put_fn`` defaults to moving every
    array or tensor value of a batch dict. An exception in the loader or in
    ``put_fn`` is raised by the consumer after the batches before it."""

    def __init__(self, loader, put_fn: Optional[Callable] = None, depth: int = 2,
                 device=None):
        import torch

        from stllm_tpu_torch.common.device import resolve_device

        self.loader = loader
        self.device = resolve_device(device)
        pin = self.device.type == "cuda"

        def put(batch):
            out = {}
            for k, v in batch.items():
                if isinstance(v, (np.ndarray, torch.Tensor)):
                    t = torch.as_tensor(v)
                    if pin:
                        t = t.pin_memory()
                    v = t.to(self.device, non_blocking=True)
                out[k] = v
            return out

        self.put_fn = put_fn or put
        self.depth = depth

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        done = object()
        failure: List[BaseException] = []

        def producer():
            try:
                for batch in self.loader:
                    q.put(self.put_fn(batch))
            except BaseException as e:  # noqa: BLE001  (handed to the consumer)
                failure.append(e)
            finally:
                q.put(done)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        while True:
            item = q.get()
            if item is done:
                break
            yield item
        th.join()
        if failure:
            raise failure[0]
