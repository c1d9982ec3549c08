"""Synthetic two-view clips (copy of the numpy-only
``video_graph_ssl_tpu/data/synthetic.py:SyntheticContrastiveDataset``),
plus the batch iterator the port's trainer feeds from it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass
class SyntheticContrastiveDataset:
    n_data: int = 256
    video_length: int = 16
    canvas_hw: Tuple[int, int] = (128, 128)
    num_classes: int = 101
    two_views: bool = True
    seed: int = 0

    def __len__(self) -> int:
        return self.n_data

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None):
        g = np.random.default_rng(self.seed * 1_000_003 + index)
        v = 2 if self.two_views else 1
        clips = g.integers(
            0, 256,
            (v, self.video_length, *self.canvas_hw, 3), dtype=np.uint8)
        label = np.int32(index % self.num_classes)
        return {"clips": clips, "label": label, "index": np.int32(index)}


def iterate_batches(ds: SyntheticContrastiveDataset, batch_size: int,
                    epoch: int, seed: int = 0) -> Iterator[dict]:
    """Shuffled full batches of one epoch (the last partial batch is
    dropped), as stacked numpy arrays."""
    order = np.random.default_rng(seed * 7919 + epoch).permutation(len(ds))
    for s in range(0, len(order) - batch_size + 1, batch_size):
        items = [ds[int(i)] for i in order[s:s + batch_size]]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}
