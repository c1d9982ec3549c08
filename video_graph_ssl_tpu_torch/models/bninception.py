"""BN-Inception (Inception-v2), the TSN 2D backbone, counterpart of
``video_graph_ssl_tpu/models/bninception.py`` (the reference's
backbone_2d/bninception.py:22-266): a 7x7/2 stem, 1x1 and 3x3 convs, then
ten Inception blocks from one plan (regular four-branch blocks with a
double 3x3 branch, and stride-2 reduction blocks), feature dim 1024.

Frames arrive as ``(N, H, W, C)`` and run as ``(N, C, H, W)`` views in
``channels_last`` memory.  Every conv is ``layers.BasicConv2d`` (no bias,
BN with flax momentum 0.9 and eps 1e-3, ReLU) under the reference's names
(``conv1``, ``inception3a.branch2.1``, ...); the reference's conv biases
fold into the BN's running mean (``utils/torch_names.py``).  The stride-2
pools pad (0, 1) on H and W, which ``ceil_mode`` gives with the same
windows; the branch pools are 3x3/1, padding 1, average pools counting the
padding (flax's ``count_include_pad``; ``layers.avg_pool3x3``) except 5b's
max pool.  The frames must give inception4e an even extent (224x224 does,
the reference's size): at 112x112 its conv branches give 4x4 and its pool
3x3, which do not concatenate, in the JAX net and the reference's alike.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .layers import AvgPool3x3, BasicConv2d, freeze_bn_

BNINCEPTION_FEATURE_DIM = 1024

# (type, spec): 'i' = Inception(ch1x1, 3x3red, 3x3, dbl_red, dbl_mid,
# dbl_bot, pool_proj, pool_kind), 'r' = reduction(3x3red, 3x3, dbl_red,
# dbl_mid, dbl_bot) (JAX bninception.py:_PLAN)
PLAN: Sequence[Tuple[str, tuple]] = (
    ("i", (64, 64, 64, 64, 96, 96, 32, "avg")),
    ("i", (64, 64, 96, 64, 96, 96, 64, "avg")),
    ("r", (128, 160, 64, 96, 96)),
    ("i", (224, 64, 96, 96, 128, 128, 128, "avg")),
    ("i", (192, 96, 128, 96, 128, 128, 128, "avg")),
    ("i", (160, 128, 160, 128, 160, 160, 128, "avg")),
    ("i", (96, 128, 192, 160, 192, 192, 128, "avg")),
    ("r", (128, 192, 192, 256, 256)),
    ("i", (352, 192, 320, 160, 224, 224, 128, "avg")),
    ("i", (352, 192, 320, 192, 224, 224, 128, "max")),
)
NAMES = ("inception3a", "inception3b", "inception3c", "inception4a", "inception4b",
         "inception4c", "inception4d", "inception4e", "inception5a", "inception5b")
EPS = 1e-3


def ceil_pool() -> nn.MaxPool2d:
    """3x3 / 2 max pool padded (0, 1) on H and W (flax ``[(0, 1), (0, 1)]``)."""
    return nn.MaxPool2d(3, 2, ceil_mode=True)


class InceptionBN(nn.Module):
    def __init__(self, cin: int, spec: tuple, dtype: torch.dtype):
        super().__init__()
        c1, c3r, c3, cdr, cdm, cdb, cp, pool_kind = spec
        kw = dict(eps=EPS, dtype=dtype)
        self.branch1 = BasicConv2d(cin, c1, **kw)
        self.branch2 = nn.Sequential(BasicConv2d(cin, c3r, **kw),
                                     BasicConv2d(c3r, c3, 3, 1, 1, **kw))
        self.branch3 = nn.Sequential(BasicConv2d(cin, cdr, **kw),
                                     BasicConv2d(cdr, cdm, 3, 1, 1, **kw),
                                     BasicConv2d(cdm, cdb, 3, 1, 1, **kw))
        pool = nn.MaxPool2d(3, 1, 1) if pool_kind == "max" else AvgPool3x3()
        self.branch4 = nn.Sequential(pool, BasicConv2d(cin, cp, **kw))
        self.out_channels = c1 + c3 + cdb + cp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x),
                          self.branch4(x)], dim=1)


class InceptionBNReduce(nn.Module):
    def __init__(self, cin: int, spec: tuple, dtype: torch.dtype):
        super().__init__()
        c3r, c3, cdr, cdm, cdb = spec
        kw = dict(eps=EPS, dtype=dtype)
        self.branch1 = nn.Sequential(BasicConv2d(cin, c3r, **kw),
                                     BasicConv2d(c3r, c3, 3, 2, 1, **kw))
        self.branch2 = nn.Sequential(BasicConv2d(cin, cdr, **kw),
                                     BasicConv2d(cdr, cdm, 3, 1, 1, **kw),
                                     BasicConv2d(cdm, cdb, 3, 2, 1, **kw))
        self.branch3 = ceil_pool()
        self.out_channels = c3 + cdb + cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x)], dim=1)


class BNInception(nn.Module):
    """Frames (N, H, W, 3) -> (N, 1024) fp32 spatial-mean features.
    ``partial_bn`` freezes every BN after ``conv1``'s."""

    feature_dim = BNINCEPTION_FEATURE_DIM

    def __init__(self, partial_bn: bool = False, dtype: torch.dtype = torch.bfloat16,
                 in_channels: int = 3):
        super().__init__()
        kw = dict(eps=EPS, dtype=dtype)
        self.conv1 = BasicConv2d(in_channels, 64, 7, 2, 3, **kw)
        self.conv2 = BasicConv2d(64, 64, **kw)
        self.conv3 = BasicConv2d(64, 192, 3, 1, 1, **kw)
        cin = 192
        for name, (kind, spec) in zip(NAMES, PLAN):
            block = (InceptionBN if kind == "i" else InceptionBNReduce)(cin, spec, dtype)
            setattr(self, name, block)
            cin = block.out_channels
        self.pool = ceil_pool()
        self.dtype = dtype
        if partial_bn:
            for name, m in self.named_children():
                if name != "conv1":
                    freeze_bn_(m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pool(self.conv1(x.permute(0, 3, 1, 2)))
        x = self.pool(self.conv3(self.conv2(x)))
        for name in NAMES:
            x = getattr(self, name)(x)
        return x.float().mean(dim=(2, 3))


def bninception(aug_points=(), graph_cfg=None, **kw) -> BNInception:
    # graph blocks are a 3D-path feature: JAX's constructor drops them
    return BNInception(**kw)

