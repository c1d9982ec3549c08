"""S3D (Xie et al., ECCV 2018) with GCA graph blocks, plain float32.

The 16 stages of the original PyTorch code (``s3d_1.py``): a stage at a
graph-block point is ``Sequential(graph block, stage)``, the block running
on the stage's input.  BN: eps 1e-3, flax momentum 0.999.  The head pools
space, then averages adjacent frames, then time.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .graph import TemporalGraphAug, stage_seed
from .nn import BatchNorm, MaxPool3d, Rounding, conv3d

MIXED = {
    5: (64, (96, 128), (16, 32), 32),
    6: (128, (128, 192), (32, 96), 64),
    8: (192, (96, 208), (16, 48), 64),
    9: (160, (112, 224), (24, 64), 64),
    10: (128, (128, 256), (24, 64), 64),
    11: (112, (144, 288), (32, 64), 64),
    12: (256, (160, 320), (32, 128), 128),
    14: (256, (160, 320), (32, 128), 128),
    15: (384, (192, 384), (48, 128), 128),
}
FEATURE_DIM = 1024


class BasicConv3d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size=1, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel_size, stride, padding, bias=False)
        self.bn = BatchNorm(cout, 0.999, 1e-3)
        self.rounding = Rounding()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(conv3d(x, self.conv, self.rounding)))


class SepConv3d(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int = 1, p: int = 0):
        super().__init__()
        self.conv_s = nn.Conv3d(cin, cout, (1, k, k), (1, s, s), (0, p, p), bias=False)
        self.bn_s = BatchNorm(cout, 0.999, 1e-3)
        self.conv_t = nn.Conv3d(cout, cout, (k, 1, 1), (s, 1, 1), (p, 0, 0), bias=False)
        self.bn_t = BatchNorm(cout, 0.999, 1e-3)
        self.rounding = Rounding()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn_s(conv3d(x, self.conv_s, self.rounding)))
        return F.relu(self.bn_t(conv3d(x, self.conv_t, self.rounding)))


class InceptionBlock(nn.Module):
    def __init__(self, cin: int, b0: int, b1: Sequence[int], b2: Sequence[int], b3: int):
        super().__init__()
        self.branch0 = nn.Sequential(BasicConv3d(cin, b0))
        self.branch1 = nn.Sequential(BasicConv3d(cin, b1[0]), SepConv3d(b1[0], b1[1], 3, 1, 1))
        self.branch2 = nn.Sequential(BasicConv3d(cin, b2[0]), SepConv3d(b2[0], b2[1], 3, 1, 1))
        self.branch3 = nn.Sequential(MaxPool3d(3, 1, 1), BasicConv3d(cin, b3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], dim=1)


def head_pool(x: torch.Tensor) -> torch.Tensor:
    y = x.mean(dim=(3, 4)).transpose(1, 2)             # (B, T', C)
    if y.shape[1] > 1:
        y = (y[:, :-1] + y[:, 1:]) * 0.5
    return y.mean(dim=1)


class S3D(nn.Module):
    """(B, T, H, W, 3) clips -> (B, 1024) features."""

    feature_dim = FEATURE_DIM

    def __init__(self, aug_points=(5, 9, 14)):
        super().__init__()
        stages = [SepConv3d(3, 64, 7, 2, 3), MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)),
                  BasicConv3d(64, 64, 1), SepConv3d(64, 192, 3, 1, 1),
                  MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))]
        cins, cin = [3, 64, 64, 64, 192], 192
        for idx in range(5, 16):
            cins.append(cin)
            if idx == 7:
                stages.append(MaxPool3d(3, 2, 1))
            elif idx == 13:
                stages.append(MaxPool3d(2, 2, 0))
            else:
                b0, b1, b2, b3 = MIXED[idx]
                stages.append(InceptionBlock(cin, b0, b1, b2, b3))
                cin = b0 + b1[1] + b2[1] + b3
        self.aug_points = tuple(aug_points)
        for idx in self.aug_points:
            stages[idx] = nn.Sequential(TemporalGraphAug(cins[idx]), stages[idx])
        self.base = nn.Sequential(*stages)

    def forward(self, x: torch.Tensor, graph_seed: int) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)
        for idx, stage in enumerate(self.base):
            if idx in self.aug_points:
                graph, stage = stage[0], stage[1]
                y = graph(x.permute(0, 2, 3, 4, 1), stage_seed(graph_seed, idx))
                x = y.permute(0, 4, 1, 2, 3)
            x = stage(x)
        return head_pool(x)
