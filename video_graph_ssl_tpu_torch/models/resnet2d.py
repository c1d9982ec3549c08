"""2D ResNets for the frame-aggregation path (``MODEL.BACKBONE_TYPE 2D``),
counterpart of ``video_graph_ssl_tpu/models/resnet2d.py`` (the reference's
torchvision-style backbone_2d/resnet.py:114-296).

Frames arrive as ``(N, H, W, C)`` (``wrappers.VisualEncoder`` folds a
clip's frames into N) and run as ``(N, C, H, W)`` views in
``channels_last`` memory.  Module names are torchvision's (``conv1``,
``bn1``, ``layerS.B.convI``/``bnI``, ``layerS.B.downsample.{0,1}``), so a
reference state_dict loads as it is.  Every BN is flax's (momentum 0.9,
eps 1e-5) through ``layers.BatchNorm``.  The pools are the library's: the
JAX nets pool with flax's ``nn.max_pool``, outside any kernel of the repo.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import tracing
from .layers import BatchNorm, conv, freeze_bn_

BN_MOMENTUM, BN_EPS = 0.9, 1e-5


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, BN_MOMENTUM, BN_EPS)


def downsample(cin: int, cout: int, stride, conv_cls=nn.Conv2d) -> nn.Sequential:
    """The shortcut's 1x1 conv (``downsample.0``) and BN (``downsample.1``)."""
    return nn.Sequential(conv_cls(cin, cout, 1, stride, bias=False), _bn(cout))


def shortcut(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The residual of ``block``: x, or its downsample's conv + BN."""
    if block.downsample is None:
        return x
    return block.downsample[1](conv(x, block.downsample[0], block.dtype)).to(block.dtype)


class BasicBlock2d(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        need = stride != 1 or cin != planes
        self.downsample = downsample(cin, planes, stride) if need else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self.bn1(conv(x, self.conv1, dt)).to(dt))
        out = self.bn2(conv(out, self.conv2, dt)).to(dt)
        return F.relu(out + shortcut(self, x))


class Bottleneck2d(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        need = stride != 1 or cin != planes * 4
        self.downsample = downsample(cin, planes * 4, stride) if need else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self.bn1(conv(x, self.conv1, dt)).to(dt))
        out = F.relu(self.bn2(conv(out, self.conv2, dt)).to(dt))
        out = self.bn3(conv(out, self.conv3, dt)).to(dt)
        return F.relu(out + shortcut(self, x))


def make_layers(owner: nn.Module, block_cls, layers: Sequence[int], dtype,
                cin: int = 64) -> List[int]:
    """``owner.layer1`` .. ``layer4``: Sequentials of ``block_cls(cin,
    planes, stride, dtype)`` at 64, 128, 256, 512 planes, stride 2 on the
    first block of stages 2-4; returns each stage's input channels and,
    last, the last stage's output channels."""
    cins = [cin]
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers), start=1):
        blocks = []
        for b in range(n):
            blocks.append(block_cls(cin, planes, 2 if (b == 0 and stage > 1) else 1,
                                    dtype=dtype))
            cin = planes * block_cls.expansion
        setattr(owner, f"layer{stage}", nn.Sequential(*blocks))
        cins.append(cin)
    return cins


class ResNet2D(nn.Module):
    """Frames (N, H, W, 3) -> (N, 512 x expansion) fp32 spatial-mean
    features.  ``partial_bn`` freezes every BN of the four stages; the
    stem's ``bn1`` stays live (JAX ``ResNet2D``)."""

    def __init__(self, block: str, layers: Sequence[int], partial_bn: bool = False,
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3):
        super().__init__()
        block_cls = BasicBlock2d if block == "basic" else Bottleneck2d
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.feature_dim = make_layers(self, block_cls, layers, dtype)[-1]
        self.dtype = dtype
        if partial_bn:
            for stage in range(1, 5):
                freeze_bn_(getattr(self, f"layer{stage}"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)
        with tracing.span("stem"):
            x = F.relu(self.bn1(conv(x, self.conv1, dt)).to(dt))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        return x.float().mean(dim=(2, 3))


def _variant(block: str, layers: Sequence[int]):
    def ctor(aug_points=(), graph_cfg=None, **kw):
        # graph blocks are a 3D-path feature: JAX's 2D constructors drop them
        return ResNet2D(block, layers, **kw)
    return ctor


resnet18 = _variant("basic", (2, 2, 2, 2))
resnet34 = _variant("basic", (3, 4, 6, 3))
resnet50 = _variant("bottleneck", (3, 4, 6, 3))
resnet101 = _variant("bottleneck", (3, 4, 23, 3))
resnet152 = _variant("bottleneck", (3, 8, 36, 3))
