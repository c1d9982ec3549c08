"""Tiny 3D backbone for CPU tests (counterpart of
``video_graph_ssl_tpu/models/tiny.py``); its one graph-aug point is 1, the
input of ``stage1``.  ``partial_bn`` freezes ``stage1`` and ``stage2``'s
BNs, as the JAX Tiny3D does."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.temporal_graph import TemporalGraphAug, stage_seed
from .layers import BasicConv3d, freeze_bn_, max_pool_3d
from .s3d import to_bthwc, to_ncdhw

TINY3D_FEATURE_DIM = 64


class Tiny3D(nn.Module):
    def __init__(self, aug_points: Tuple[int, ...] = (),
                 graph_cfg: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.bfloat16, partial_bn: bool = False,
                 in_channels: int = 3, remat=False):
        super().__init__()
        self.remat = remat   # TPU.REMAT, carried unread as the JAX Tiny3D carries it
        self.stage0 = BasicConv3d(in_channels, 16, 3, 2, 1, dtype=dtype)
        self.aug_points = tuple(int(i) for i in aug_points)
        if 1 in self.aug_points:
            self.graph_aug_1 = TemporalGraphAug(16, dtype=dtype,
                                                **(graph_cfg or {}))
        self.stage1 = BasicConv3d(16, 32, 3, 2, 1, dtype=dtype)
        self.stage2 = BasicConv3d(32, TINY3D_FEATURE_DIM, 1, 1, 0, dtype=dtype)
        self.dtype = dtype
        if partial_bn:
            freeze_bn_(self.stage1)
            freeze_bn_(self.stage2)

    @property
    def feature_dim(self) -> int:
        return TINY3D_FEATURE_DIM

    def forward(self, x: torch.Tensor, graph_seed: int = 0,
                graph_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        x = self.stage0(to_ncdhw(x).to(self.dtype))
        if 1 in self.aug_points:
            x = to_ncdhw(self.graph_aug_1(to_bthwc(x), seed=stage_seed(graph_seed, 1),
                                          rows=graph_rows))
        x = self.stage1(x)
        x = max_pool_3d(x, (1, 2, 2), (1, 2, 2))
        x = self.stage2(x)
        return x.float().mean(dim=(2, 3, 4))
