"""3D ResNets (R3D) and the factorized ``resnet_i3d`` family, counterpart
of ``video_graph_ssl_tpu/models/resnet3d.py`` (the reference's
backbone_3d/resnet.py:109-257 and resnet_i3d.py:141-249).

conv1 7x7x7 / (1, 2, 2), BN, ReLU, the 3x3x3 / 2 stem pool (padding 1)
through ``ops/maxpool.max_pool3d``, whose backward on a CUDA tensor is
kernel K4; four stages of blocks, stride 2 in T, H and W at the first
block of stages 2-4; the spatio-temporal mean.  With ``aug_points`` (of
1-4; the reference's default is 2, 3, 4) a stage's input first passes a
graph block (``ops/temporal_graph.TemporalGraphAug``, K1 and K2 on CUDA
tensors): ``layerS`` becomes ``Sequential(graph, stage)``, the reference's
wrapping, so the stage's names move to ``layerS.1.*`` and the block's are
``layerS.0.*``.

Module names are the reference's: torchvision's for R3D (``conv1``,
``bn1``, ``layerS.B.convI``/``bnI``, ``layerS.B.downsample.{0,1}``), and
resnet_i3d.py's for the factorized blocks: the basic block's spatial and
temporal halves ``convI_1``/``bnI_1`` and ``convI_2``/``bnI_2``; the
bottleneck's middle pair ``conv2.{conv1,bn1,conv2,bn2}`` and its last
conv's BN ``bn2`` (the reference's own name for it).  The bottleneck
follows the JAX block, which leaves out the reference's ReLU before the
residual add (``utils/torch_interop.py:convert_torch_resnet_i3d``).

Activations are ``(B, C, T, H, W)`` in ``channels_last_3d`` memory; every
BN is flax's (momentum 0.9, eps 1e-5) through ``layers.BatchNorm``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.temporal_graph import TemporalGraphAug, stage_seed
from . import remat
from .layers import conv, freeze_bn_, max_pool_3d
from .resnet2d import _bn, downsample, make_layers, shortcut
from .s3d import to_bthwc, to_ncdhw


class BasicBlock3d(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        need = stride != 1 or cin != planes
        self.downsample = downsample(cin, planes, stride, nn.Conv3d) if need else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self.bn1(conv(x, self.conv1, dt)).to(dt))
        out = self.bn2(conv(out, self.conv2, dt)).to(dt)
        return F.relu(out + shortcut(self, x))


class Bottleneck3d(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv3d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        need = stride != 1 or cin != planes * 4
        self.downsample = downsample(cin, planes * 4, stride, nn.Conv3d) if need else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self.bn1(conv(x, self.conv1, dt)).to(dt))
        out = F.relu(self.bn2(conv(out, self.conv2, dt)).to(dt))
        out = self.bn3(conv(out, self.conv3, dt)).to(dt)
        return F.relu(out + shortcut(self, x))


def spatial_conv(cin: int, cout: int, stride: int) -> nn.Conv3d:
    """(1, 3, 3) / (1, s, s), padding (0, 1, 1)."""
    return nn.Conv3d(cin, cout, (1, 3, 3), (1, stride, stride), (0, 1, 1), bias=False)


def temporal_conv(cin: int, cout: int, stride: int) -> nn.Conv3d:
    """(3, 1, 1) / (s, 1, 1), padding (1, 0, 0)."""
    return nn.Conv3d(cin, cout, (3, 1, 1), (stride, 1, 1), (1, 0, 0), bias=False)


class FactorizedBasicBlock3d(nn.Module):
    """Each 3x3x3 conv of the basic block as a spatial (1,3,3) conv + BN +
    ReLU and a temporal (3,1,1) conv + BN, the stride split (1,s,s)·(s,1,1);
    ReLU after the first pair only (JAX ``FactorizedBasicBlock3d``)."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1_1 = spatial_conv(cin, planes, stride)
        self.bn1_1 = _bn(planes)
        self.conv1_2 = temporal_conv(planes, planes, stride)
        self.bn1_2 = _bn(planes)
        self.conv2_1 = spatial_conv(planes, planes, 1)
        self.bn2_1 = _bn(planes)
        self.conv2_2 = temporal_conv(planes, planes, 1)
        self.bn2_2 = _bn(planes)
        need = stride != 1 or cin != planes
        self.downsample = downsample(cin, planes, stride, nn.Conv3d) if need else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self.bn1_1(conv(x, self.conv1_1, dt)).to(dt))
        out = F.relu(self.bn1_2(conv(out, self.conv1_2, dt)).to(dt))
        out = F.relu(self.bn2_1(conv(out, self.conv2_1, dt)).to(dt))
        out = self.bn2_2(conv(out, self.conv2_2, dt)).to(dt)
        return F.relu(out + shortcut(self, x))


class STConv3d(nn.Module):
    """The reference's BasicSTConv3d: spatial (1,3,3)/(1,s,s) conv + BN +
    ReLU, then temporal (3,1,1)/(s,1,1) conv + BN + ReLU."""

    def __init__(self, cin: int, cout: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = spatial_conv(cin, cout, stride)
        self.bn1 = _bn(cout)
        self.conv2 = temporal_conv(cout, cout, stride)
        self.bn2 = _bn(cout)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = F.relu(self.bn1(conv(x, self.conv1, dt)).to(dt))
        return F.relu(self.bn2(conv(x, self.conv2, dt)).to(dt))


class FactorizedBottleneck3d(nn.Module):
    """1x1x1 -> the factorized middle pair (``conv2``) -> 1x1x1 (x4), whose
    BN is ``bn2`` (JAX ``FactorizedBottleneck3d``)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = STConv3d(planes, planes, stride, dtype)
        self.conv3 = nn.Conv3d(planes, planes * 4, 1, bias=False)
        self.bn2 = _bn(planes * 4)
        need = stride != 1 or cin != planes * 4
        self.downsample = downsample(cin, planes * 4, stride, nn.Conv3d) if need else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self.bn1(conv(x, self.conv1, dt)).to(dt))
        out = self.conv2(out)
        out = self.bn2(conv(out, self.conv3, dt)).to(dt)
        return F.relu(out + shortcut(self, x))


BLOCKS = {"basic": BasicBlock3d, "bottleneck": Bottleneck3d,
          "fbasic": FactorizedBasicBlock3d, "fbottleneck": FactorizedBottleneck3d}


class ResNetStages(nn.Module):
    """The four stages of a 3D ResNet (R3D, resnet_i3d, R(2+1)D) after its
    stem: ``layer1`` .. ``layer4``, graph blocks on the inputs of the
    stages in ``aug_points``; ``partial_bn`` freezes every BN of the stages
    outside the graph blocks (the stem's stay live, JAX ``ResNet3D``);
    ``remat`` (``TPU.REMAT``) recomputes each residual block in the
    backward, as JAX ``nn.remat``s its block class.  Subclasses build the
    stem and call :meth:`_stages`, then :meth:`_run` on its output."""

    remat: remat.Policy = False

    def _stages(self, block_cls, layers: Sequence[int], aug_points, graph_cfg,
                partial_bn: bool, dtype: torch.dtype, policy: remat.Policy = False) -> None:
        self.aug_points = tuple(int(i) for i in aug_points)
        self.remat = remat.check_policy(policy)
        cins = make_layers(self, block_cls, layers, dtype)
        for stage in range(1, 5):
            layer = getattr(self, f"layer{stage}")
            if partial_bn:
                freeze_bn_(layer)
            if stage in self.aug_points:
                graph = TemporalGraphAug(cins[stage - 1], dtype=dtype, **(graph_cfg or {}))
                setattr(self, f"layer{stage}", nn.Sequential(graph, layer))
        self.feature_dim = cins[-1]
        self.dtype = dtype

    def _run(self, x: torch.Tensor, seed: int, rows) -> torch.Tensor:
        for stage in range(1, 5):
            layer = getattr(self, f"layer{stage}")
            if stage in self.aug_points:
                graph, layer = layer[0], layer[1]
                x = to_ncdhw(graph(to_bthwc(x), seed=stage_seed(seed, stage), rows=rows))
            for block in layer:
                x = remat.run(block, x, self.remat)
            x = self._after_stage(stage, x)
        return x.float().mean(dim=(2, 3, 4))

    def _after_stage(self, stage: int, x: torch.Tensor) -> torch.Tensor:
        """What runs between ``layer{stage}`` and the next stage's graph
        block: nothing here (``i3dnon``'s temporal pool after layer1)."""
        return x


class ResNet3D(ResNetStages):
    """R3D / resnet_i3d encoder: (B, T, H, W, 3) clips -> (B, 512 x
    expansion) fp32 features.  ``block``: basic, bottleneck (R3D), fbasic,
    fbottleneck (resnet_i3d)."""

    def __init__(self, block: str, layers: Sequence[int], aug_points: Tuple[int, ...] = (),
                 graph_cfg: Optional[Dict[str, Any]] = None, partial_bn: bool = False,
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3,
                 remat: remat.Policy = False):
        super().__init__()
        self.conv1 = nn.Conv3d(in_channels, 64, 7, (1, 2, 2), 3, bias=False)
        self.bn1 = _bn(64)
        self._stages(BLOCKS[block], layers, aug_points, graph_cfg, partial_bn, dtype, remat)

    def forward(self, x: torch.Tensor, graph_seed: int = 0,
                graph_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        dt = self.dtype
        x = F.relu(self.bn1(conv(to_ncdhw(x), self.conv1, dt)).to(dt))
        x = max_pool_3d(x, 3, 2, 1)
        return self._run(x, graph_seed, graph_rows)


def _variant(block: str, layers: Sequence[int]):
    def ctor(**kw):
        return ResNet3D(block, layers, **kw)
    return ctor


DEPTHS = {10: ("basic", (1, 1, 1, 1)), 18: ("basic", (2, 2, 2, 2)),
          34: ("basic", (3, 4, 6, 3)), 50: ("bottleneck", (3, 4, 6, 3)),
          101: ("bottleneck", (3, 4, 23, 3)), 152: ("bottleneck", (3, 8, 36, 3)),
          200: ("bottleneck", (3, 24, 36, 3))}
# R3D: resnet3d_{10..200}; the factorized family under JAX's exported names
RESNET3D = {f"resnet3d_{d}": _variant(block, layers) for d, (block, layers) in DEPTHS.items()}
RESNET_I3D = {f"resnet_i3d_{d}": _variant("f" + DEPTHS[d][0], DEPTHS[d][1])
              for d in (18, 50, 101)}
