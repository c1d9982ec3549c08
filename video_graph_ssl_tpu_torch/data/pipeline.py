"""Host data loader: shuffling, batching, threaded prefetch, device feed.

Counterpart of ``video_graph_ssl_tpu/data/pipeline.py:Loader``: the same
epoch order, the same per-item rngs, so both packages draw the same batches
from the same dataset and seed.  ONE global batch per step, a thread pool
for the IO-bound item fetch, and a bounded prefetch queue that overlaps the
host fetch with device compute.  Under several ranks,
``batch_slice=(lo, hi)`` (``parallel.dist.process_batch_slice``) restricts
each rank to its rows of every global batch -- the ``DistributedSampler``
role -- while the epoch shuffle and the per-item rngs stay keyed on global
indices, so the ranks' rows together are the one-process batch stream, bit
for bit.

Determinism: per-epoch, per-item numpy Generators seeded as
``(seed, epoch, index)``; the epoch shuffle is ``default_rng((seed,
epoch))``.

:func:`to_device` is the port's counterpart of the JAX package's
``shard_batch``: a pinned host copy, then a ``non_blocking`` copy to the
card.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch


def _stack_batch(items) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items], axis=0) for k in items[0]}


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch array on ``device``: pinned, then copied without
    blocking the host (on the CPU, the array itself as a tensor)."""
    t = torch.from_numpy(array)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class Loader:
    """Epoch-based batch loader over a map-style dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        prefetch: int = 2,
        batch_slice=None,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(int(num_workers), 1)
        self.seed = int(seed)
        self.prefetch = max(int(prefetch), 1)
        if batch_slice is not None:
            lo, hi = int(batch_slice[0]), int(batch_slice[1])
            if not (0 <= lo < hi <= self.batch_size):
                raise ValueError(
                    f"batch_slice {batch_slice} outside batch {batch_size}")
            if not self.drop_last:
                # a ragged tail batch has no well-defined per-rank rows
                raise ValueError("batch_slice requires drop_last=True")
            batch_slice = (lo, hi)
        self.batch_slice = batch_slice

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def n_data(self) -> int:
        return len(self.dataset)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            # DistributedSampler.set_epoch equivalent (reference:
            # train_video_contrast_dis.py:588)
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        return order

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order(epoch)
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def fetch_item(idx: int):
            rng = np.random.default_rng((self.seed, epoch, int(idx)))
            return self.dataset.__getitem__(int(idx), rng=rng)

        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone (a blocked
            put would keep the pool's workers, and the process, alive)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            break
                        idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                        if self.batch_slice is not None:
                            idxs = idxs[self.batch_slice[0]:self.batch_slice[1]]
                        if not put(_stack_batch(list(pool.map(fetch_item, idxs)))):
                            break
                put(None)
            except Exception as e:  # surface worker errors to the consumer
                put(e)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
