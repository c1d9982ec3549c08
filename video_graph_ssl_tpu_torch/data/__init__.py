"""Data: split parsing, frame samplers, decode, shard stores, the loader,
on-device augmentation and synthetic sources (the JAX package's
``data`` exports, without ``video_io``)."""

from .build import build_video_contrastive_loader, make_data_loader, make_test_loader
from .datasets import ContrastiveDataset, FrameDataset
from .pipeline import Loader
from .records import VideoRecord, parse_split
from .shards import ShardStore, write_shard_store
from .synthetic import SyntheticContrastiveDataset, SyntheticFrameDataset
from .transforms_device import make_batch_augment_fn

__all__ = [
    "build_video_contrastive_loader",
    "make_data_loader",
    "make_test_loader",
    "ContrastiveDataset",
    "FrameDataset",
    "Loader",
    "VideoRecord",
    "parse_split",
    "SyntheticContrastiveDataset",
    "SyntheticFrameDataset",
    "make_batch_augment_fn",
    "ShardStore",
    "write_shard_store",
]
