"""R(2+1)D: ResNets whose 3x3x3 convs are (1,3,3) spatial + (3,1,1)
temporal pairs, counterpart of ``video_graph_ssl_tpu/models/resnet2p1d.py``
(the reference's backbone_3d/resnet2p1d.py:139-285).

A pair's middle width follows the parameter-matching rule :func:`mid`, so
each pair has about the parameters of the 3D conv it replaces; the stem is
(1,7,7)/(1,2,2) to a width of ``mid(3, 64, 7, 7)`` = 110, then (7,1,1) to
64, then the 3x3x3 / 2 stem pool (K4's backward on CUDA tensors).  Graph
blocks, partial BN and the head are R3D's (``resnet3d.ResNetStages``).

Module names are the reference's: the stem's ``conv1_s``/``bn1_s`` and
``conv1_t``/``bn1_t``; a basic block's pairs ``convI_s``/``bnI_s`` (the
pair's own BN) and ``convI_t``/``bnI_t`` (the BN after the pair); a
bottleneck's ``conv1``/``bn1``, ``conv2_s``/``bn2_s``/``conv2_t``/``bn2_t``
and ``conv3``/``bn3``; ``downsample.{0,1}``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import remat
from .layers import conv, max_pool_3d
from .resnet2d import _bn, downsample, shortcut
from .resnet3d import DEPTHS, ResNetStages, spatial_conv, temporal_conv
from .s3d import to_ncdhw


def mid(cin: int, cout: int, kt: int = 3, ks: int = 3) -> int:
    """The pair's middle width: (cin cout kt ks ks) // (cin ks ks + kt cout)."""
    return (cin * cout * kt * ks * ks) // (cin * ks * ks + kt * cout)


def _pair(block: nn.Module, i: int, x: torch.Tensor, relu: bool) -> torch.Tensor:
    """Pair ``i`` of ``block``: spatial conv, its BN, ReLU, temporal conv,
    then the block's BN after the pair, and ReLU where ``relu``."""
    dt = block.dtype
    x = F.relu(getattr(block, f"bn{i}_s")(conv(x, getattr(block, f"conv{i}_s"), dt)).to(dt))
    x = getattr(block, f"bn{i}_t")(conv(x, getattr(block, f"conv{i}_t"), dt)).to(dt)
    return F.relu(x) if relu else x


class BasicBlock2p1d(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        for i, c in ((1, cin), (2, planes)):
            m = mid(c, planes)
            s = stride if i == 1 else 1
            setattr(self, f"conv{i}_s", spatial_conv(c, m, s))
            setattr(self, f"bn{i}_s", _bn(m))
            setattr(self, f"conv{i}_t", temporal_conv(m, planes, s))
            setattr(self, f"bn{i}_t", _bn(planes))
        need = stride != 1 or cin != planes
        self.downsample = downsample(cin, planes, stride, nn.Conv3d) if need else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _pair(self, 2, _pair(self, 1, x, True), False)
        return F.relu(out + shortcut(self, x))


class Bottleneck2p1d(nn.Module):
    """1x1x1 -> pair (mid = 27 planes // 12) -> 1x1x1 (x4)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        m = mid(planes, planes)
        self.conv1 = nn.Conv3d(cin, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2_s = spatial_conv(planes, m, stride)
        self.bn2_s = _bn(m)
        self.conv2_t = temporal_conv(m, planes, stride)
        self.bn2_t = _bn(planes)
        self.conv3 = nn.Conv3d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        need = stride != 1 or cin != planes * 4
        self.downsample = downsample(cin, planes * 4, stride, nn.Conv3d) if need else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self.bn1(conv(x, self.conv1, dt)).to(dt))
        out = _pair(self, 2, out, True)
        out = self.bn3(conv(out, self.conv3, dt)).to(dt)
        return F.relu(out + shortcut(self, x))


STEM_MID = mid(3, 64, 7, 7)


class ResNet2Plus1D(ResNetStages):
    """R(2+1)D encoder: (B, T, H, W, 3) clips -> (B, 512 x expansion) fp32
    features."""

    def __init__(self, layers: Sequence[int], block_type: str = "basic",
                 aug_points: Tuple[int, ...] = (), graph_cfg: Optional[Dict[str, Any]] = None,
                 partial_bn: bool = False, dtype: torch.dtype = torch.bfloat16,
                 in_channels: int = 3, remat: remat.Policy = False):
        super().__init__()
        # the stem's mid width is the RGB stem's whatever the input (JAX
        # resnet2p1d.py:142)
        self.conv1_s = nn.Conv3d(in_channels, STEM_MID, (1, 7, 7), (1, 2, 2), (0, 3, 3), bias=False)
        self.bn1_s = _bn(STEM_MID)
        self.conv1_t = nn.Conv3d(STEM_MID, 64, (7, 1, 1), 1, (3, 0, 0), bias=False)
        self.bn1_t = _bn(64)
        block = BasicBlock2p1d if block_type == "basic" else Bottleneck2p1d
        self._stages(block, layers, aug_points, graph_cfg, partial_bn, dtype, remat)

    def forward(self, x: torch.Tensor, graph_seed: int = 0,
                graph_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        x = _pair(self, 1, to_ncdhw(x), True)
        x = max_pool_3d(x, 3, 2, 1)
        return self._run(x, graph_seed, graph_rows)


def _variant(block_type: str, layers: Sequence[int]):
    def ctor(**kw):
        return ResNet2Plus1D(layers, block_type, **kw)
    return ctor


RESNET2P1D = {f"resnet2p1d_{d}": _variant(block, layers)
              for d, (block, layers) in DEPTHS.items()}
