"""Frame-folder datasets (a copy of ``video_graph_ssl_tpu/data/datasets.py``).

Counterparts of the reference's ``BaseDataset``
(lib/data/datasets/dataset.py:26-205) and ``VisualDataset``
(lib/data/datasets/video_contrast_dataset.py:28-216), reshaped for a device
pipeline: a dataset item is *raw decoded frames on a fixed canvas* (uint8);
all augmentation runs later on the device.  Two-view items keep an explicit
views axis instead of channel concatenation.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import samplers
from .decode import load_clip
from .records import VideoRecord, parse_split
from .shards import ShardStore


@dataclass
class FrameDataset:
    """Downstream (classification) dataset — BaseDataset counterpart.

    ``test_mode`` with ``num_clips`` returns (num_clips, T, H, W, C); train
    and val return (T, H, W, C).
    """

    root_path: str
    list_file: str
    video_length: int = 16
    sample_type: str = "uniform"
    sample_rate: int = 4
    modality: str = "RGB"
    image_tmpl: str = "img_{:05d}.jpg"
    pre_load: str = "cv2"
    canvas_hw: Tuple[int, int] = (256, 256)
    random_shift: bool = True
    test_mode: bool = False
    num_clips: int = 10
    new_length: int = 1
    # adversarial multi-sample mode (reference: use_adver/nsamples,
    # dataset.py:113-135): returns (nsamples, T, H, W, C)
    use_adver: bool = False
    nsamples: int = 40

    def __post_init__(self):
        self.video_list = parse_split(self.list_file)
        if self.modality == "RGBDiff":
            self.new_length += 1
        # pre_load='shard': root_path is a shard-store dir (data/shards.py);
        # frames come from mmapped pre-resized binaries, no JPEG decode.
        self._store = (ShardStore(self.root_path)
                       if self.pre_load == "shard" else None)

    def __len__(self) -> int:
        return len(self.video_list)

    def _load(self, record: VideoRecord, indices) -> np.ndarray:
        if self._store is not None:
            return self._store.load_clip(record.path, indices,
                                         new_length=self.new_length,
                                         num_frames=record.num_frames)
        directory = os.path.join(self.root_path, record.path)
        return load_clip(directory, self.image_tmpl, indices,
                         self.pre_load, self.canvas_hw, self.modality,
                         new_length=self.new_length,
                         num_frames=record.num_frames)

    def _indices(self, record: VideoRecord,
                 rng: Optional[np.random.Generator]) -> np.ndarray:
        n, L = record.num_frames, self.video_length
        if self.use_adver and not self.test_mode:
            return samplers.adver_indices(n, L, self.nsamples,
                                          self.new_length, rng)
        if self.test_mode:
            if self.num_clips > 0:
                return samplers.nclips_test_indices(n, L, self.num_clips,
                                                    self.sample_rate)
            return samplers.test_indices(n, L, self.new_length)
        if self.sample_type == "uniform":
            if self.random_shift:
                return samplers.sample_indices_uniform(n, L, self.new_length,
                                                       rng)
            return samplers.val_indices(n, L, self.new_length)
        if self.sample_type == "dense":
            if self.random_shift:
                return samplers.dense_indices(n, L, self.sample_rate, rng)
            return samplers.val_indices(n, L, self.new_length)
        raise ValueError(f"unknown sample type {self.sample_type}")

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None):
        record = self.video_list[index]
        indices = self._indices(record, rng)
        clip = self._load(record, indices)
        if self.test_mode and self.num_clips > 0:
            clip = clip.reshape((self.num_clips, self.video_length)
                                + clip.shape[1:])
        elif self.use_adver:
            clip = clip.reshape((self.nsamples, self.video_length)
                                + clip.shape[1:])
        return {"clips": clip, "label": np.int32(record.label),
                "index": np.int32(index)}


@dataclass
class ContrastiveDataset:
    """Two-view SSL dataset — VisualDataset counterpart.

    Returns ``{'clips': (2, T, H, W, C) uint8, 'label', 'index'}``; the
    ``index`` feeds the memory bank (video_contrast_dataset.py:151-169).
    ``temporal_jitter`` draws two independent index sets (:154-164);
    otherwise both views share frames (and differ only by augmentation).
    """

    root_path: str
    list_file: str
    video_length: int = 16
    frame_interval: int = 4
    sample_type: str = "dense"
    modality: str = "RGB"
    image_tmpl: str = "img_{:05d}.jpg"
    pre_load: str = "cv2"
    canvas_hw: Tuple[int, int] = (256, 256)
    temporal_jitter: bool = True
    random_shift: bool = True
    two_views: bool = True
    new_length: int = 1

    def __post_init__(self):
        self.video_list = parse_split(self.list_file)
        if self.modality == "RGBDiff":
            # +1 frame per segment, differenced on device
            # (reference dataset.py:47-48)
            self.new_length += 1
        self._store = (ShardStore(self.root_path)
                       if self.pre_load == "shard" else None)

    def __len__(self) -> int:
        return len(self.video_list)

    def _load(self, record: VideoRecord, indices) -> np.ndarray:
        if self._store is not None:
            return self._store.load_clip(record.path, indices,
                                         new_length=self.new_length,
                                         num_frames=record.num_frames)
        directory = os.path.join(self.root_path, record.path)
        return load_clip(directory, self.image_tmpl, indices,
                         self.pre_load, self.canvas_hw, self.modality,
                         new_length=self.new_length,
                         num_frames=record.num_frames)

    def _one_view(self, record: VideoRecord,
                  rng: Optional[np.random.Generator]) -> np.ndarray:
        n, L = record.num_frames, self.video_length
        if self.sample_type == "uniform":
            if self.random_shift:
                return samplers.sample_indices_uniform(n, L, rng=rng,
                                                       contrast=True)
            return samplers.val_indices(n, L, contrast=True)
        if self.sample_type == "dense":
            return samplers.dense_indices(n, L, self.frame_interval, rng)
        raise ValueError(f"unknown sample type {self.sample_type}")

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None):
        record = self.video_list[index]
        idx1 = self._one_view(record, rng)
        if self.temporal_jitter:
            idx2 = self._one_view(record, rng)
        else:
            idx2 = idx1
        v1 = self._load(record, idx1)
        if self.two_views:
            v2 = self._load(record, idx2)
            clips = np.stack([v1, v2], axis=0)
        else:
            clips = v1[None]
        return {"clips": clips, "label": np.int32(record.label),
                "index": np.int32(index)}
