"""Synthetic clip sources (copies of the numpy-only
``video_graph_ssl_tpu/data/synthetic.py:SyntheticContrastiveDataset`` and
``SyntheticFrameDataset``): deterministic uint8 clips, no disk, no decode.
They go through :class:`~video_graph_ssl_tpu_torch.data.pipeline.Loader`
like any dataset (``data/build.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

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


@dataclass
class SyntheticFrameDataset:
    n_data: int = 256
    video_length: int = 16
    canvas_hw: Tuple[int, int] = (128, 128)
    num_classes: int = 101
    test_mode: bool = False
    num_clips: int = 10
    seed: int = 0

    def __len__(self) -> int:
        return self.n_data

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None):
        g = np.random.default_rng(self.seed * 1_000_003 + index)
        if self.test_mode and self.num_clips > 0:
            shape = (self.num_clips, self.video_length, *self.canvas_hw, 3)
        else:
            shape = (self.video_length, *self.canvas_hw, 3)
        clips = g.integers(0, 256, shape, dtype=np.uint8)
        label = np.int32(index % self.num_classes)
        return {"clips": clips, "label": label, "index": np.int32(index)}
