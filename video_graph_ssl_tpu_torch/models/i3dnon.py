"""I3D-ResNet-50 with non-local blocks (``i3d_res50_nonlocal``), counterpart
of ``video_graph_ssl_tpu/models/i3dnon.py``.

conv1 (5, 7, 7) / (2, 2, 2), pads (2, 3, 3), BN, ReLU; the 3x3x3 / 2 stem
pool (padding 1) and, after layer1, the temporal pool (3, 1, 1) / (2, 1, 1),
pads (1, 0, 0), both through ``ops/maxpool.max_pool3d``, whose backward on a
CUDA tensor is kernel K4.  Four stages of inflated bottlenecks: conv1 (k,
1, 1) with k 3 on block 0 and the odd blocks, else 1; conv2 (1, 3, 3) / (1,
s, s); conv3 1x1x1 (x4); stride 2 in H and W only (T is not strided), at
the first block of stages 2-4.  A stack of 4 or 23 blocks (layer2 of the
(3, 4, 6, 3) network) carries a non-local block on each odd block after the
first, ``layer2.1`` and ``layer2.3``: JAX places them by ``n_blocks in (4,
23)`` (``i3dnon.py:186``), whatever its module docstring says.  JAX's fixes
of the reference's two bugs are kept: the non-local block is a registered,
trained submodule, and layer3 has all 6 blocks.

With ``aug_points`` (of 1-4; the registry's default is 2, 3, 4) a stage's
input first passes a graph block (K1, K2 on CUDA tensors); ``layerS``
becomes ``Sequential(graph, stage)``, as in ``resnet3d.py``.  At 16 frames
T is 2 at every graph block: conv1 and the stem pool halve it, and so does
the pool after layer1.

Partial BN (``partial_bn``) freezes every BN of every block but
``layer1.0``, the non-local blocks' ``w_bn`` included; the stem's BN,
``layer1.0``'s and the graph blocks' stay live (JAX ``i3dnon.py:170,189``:
``train and not partial_bn`` after the first block).

Module names are JAX's fields under torchvision's conventions (``conv1``,
``bn1``, ``layerS.B.convI``/``bnI``, ``layerS.B.downsample.{0,1}``, and
``layerS.B.non_local.{theta,phi,g,w_out,w_bn}``); the reference's
checkpoints hold neither the non-local weights nor layer3's last five
blocks, so no reference name map exists (JAX ``i3dnon.py:29-33``).
Every BN is flax's (momentum 0.9, eps 1e-5).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.matmul import bmm_f32
from ..ops.temporal_graph import TemporalGraphAug
from ..utils import tracing
from .layers import conv, freeze_bn_, max_pool_3d
from .resnet2d import _bn, downsample, shortcut
from .resnet3d import ResNetStages
from .s3d import to_ncdhw

I3DNON_FEATURE_DIM = 2048


def _dense(x: torch.Tensor, m: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A biased flax Dense in ``dtype`` (fp32 parameters cast to it)."""
    return F.linear(x.to(dtype), m.weight.to(dtype), m.bias.to(dtype))


class NonLocalBlock3D(nn.Module):
    """Embedded-Gaussian non-local block over the T x H x W positions (JAX
    ``NonLocalBlock3D``): biased 1x1x1 projections theta, phi, g to
    ``max(c // 2, 1)`` channels; phi and g max-pooled 2x2 / 2 per frame
    (VALID, the library's pool: JAX's is ``nn.max_pool``, outside any
    kernel); softmax over theta . phi^T summed in fp32, cast to the compute
    dtype, times g (fp32 sum, cast); ``w_out`` back to c channels and
    ``w_bn``, whose scale starts at zero, so the block starts as the
    identity.  x (B, C, T, H, W) in ``channels_last_3d`` memory."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        inter = max(channels // 2, 1)
        self.theta = nn.Linear(channels, inter)
        self.phi = nn.Linear(channels, inter)
        self.g = nn.Linear(channels, inter)
        self.w_out = nn.Linear(inter, channels)
        self.w_bn = _bn(channels)
        nn.init.zeros_(self.w_bn.weight)
        self.dtype = dtype

    @staticmethod
    def _pooled(h: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, c) -> (B, T H' W', c), pooled 2x2 / 2 per frame."""
        b, t, hh, ww, c = h.shape
        h = F.max_pool2d(h.reshape(b * t, hh, ww, c).permute(0, 3, 1, 2), 2, 2)
        return h.permute(0, 2, 3, 1).reshape(b, -1, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        xc = x.permute(0, 2, 3, 4, 1)
        b, t, h, w, _ = xc.shape
        theta = _dense(xc, self.theta, dt).reshape(b, t * h * w, -1)
        phi = self._pooled(_dense(xc, self.phi, dt))
        g = self._pooled(_dense(xc, self.g, dt))
        attn = torch.softmax(bmm_f32(theta, phi.transpose(1, 2)), dim=-1).to(dt)
        y = bmm_f32(attn, g).to(dt).reshape(b, t, h, w, -1)
        y = self.w_bn(_dense(y, self.w_out, dt), channel_dim=-1).to(dt)
        return x + y.permute(0, 4, 1, 2, 3)


class InflatedBottleneck(nn.Module):
    """(k, 1, 1) conv1, (1, 3, 3) / (1, s, s) conv2, 1x1x1 conv3 (x4), each
    with its BN; the shortcut's 1x1x1 / (1, s, s) conv + BN where the shape
    changes; ReLU after the add, then the non-local block where
    ``add_nonlocal`` (JAX ``InflatedBottleneck``)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, time_kernel: int = 3, stride: int = 1,
                 add_nonlocal: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        tk = time_kernel
        self.conv1 = nn.Conv3d(cin, planes, (tk, 1, 1), 1, ((tk - 1) // 2, 0, 0), bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv3d(planes, planes, (1, 3, 3), (1, stride, stride), (0, 1, 1),
                               bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv3d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        need = stride != 1 or cin != planes * 4
        self.downsample = (downsample(cin, planes * 4, (1, stride, stride), nn.Conv3d)
                           if need else None)
        self.non_local = NonLocalBlock3D(planes * 4, dtype=dtype) if add_nonlocal else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = F.relu(self.bn1(conv(x, self.conv1, dt)).to(dt))
        out = F.relu(self.bn2(conv(out, self.conv2, dt)).to(dt))
        out = self.bn3(conv(out, self.conv3, dt)).to(dt)
        out = F.relu(out + shortcut(self, x))
        return out if self.non_local is None else self.non_local(out)


def time_kernel(b: int) -> int:
    """The temporal kernel of block ``b`` of a stack (JAX ``i3dnon.py:185``)."""
    return 3 if (b == 0 or b % 2 == 1) else 1


def adds_nonlocal(n_blocks: int, b: int) -> bool:
    """Whether block ``b`` of an ``n_blocks`` stack carries a non-local
    block (JAX ``i3dnon.py:186``)."""
    return n_blocks in (4, 23) and b > 0 and b % 2 == 1


class I3DResNetNonLocal(ResNetStages):
    """(B, T, H, W, in_channels) clips -> (B, 2048) fp32 features (JAX
    ``I3DResNetNonLocal``)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), aug_points: Tuple[int, ...] = (),
                 graph_cfg: Optional[Dict[str, Any]] = None, partial_bn: bool = False,
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3, remat=False):
        # remat (TPU.REMAT) is taken and not read, as JAX's I3DResNetNonLocal
        # carries it unread (i3dnon.py:152)
        super().__init__()
        self.conv1 = nn.Conv3d(in_channels, 64, (5, 7, 7), 2, (2, 3, 3), bias=False)
        self.bn1 = _bn(64)
        self.aug_points = tuple(int(i) for i in aug_points)
        cin = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers), start=1):
            blocks = []
            for b in range(n):
                blocks.append(InflatedBottleneck(cin if b == 0 else planes * 4, planes,
                                                 time_kernel(b), 2 if (b == 0 and stage > 1)
                                                 else 1, adds_nonlocal(n, b), dtype))
                if partial_bn and (stage > 1 or b > 0):
                    freeze_bn_(blocks[-1])
            layer = nn.Sequential(*blocks)
            if stage in self.aug_points:
                layer = nn.Sequential(TemporalGraphAug(cin, dtype=dtype, **(graph_cfg or {})),
                                      layer)
            setattr(self, f"layer{stage}", layer)
            cin = planes * 4
        self.feature_dim = cin
        self.dtype = dtype

    def forward(self, x: torch.Tensor, graph_seed: int = 0,
                graph_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        dt = self.dtype
        with tracing.span("stem"):
            x = F.relu(self.bn1(conv(to_ncdhw(x), self.conv1, dt)).to(dt))
        x = max_pool_3d(x, 3, 2, 1)
        return self._run(x, graph_seed, graph_rows)

    def _after_stage(self, stage: int, x: torch.Tensor) -> torch.Tensor:
        # the temporal pool after layer1 (JAX i3dnon.py:193)
        return max_pool_3d(x, (3, 1, 1), (2, 1, 1), (1, 0, 0)) if stage == 1 else x


def i3d_res50_nonlocal(**kw) -> I3DResNetNonLocal:
    return I3DResNetNonLocal((3, 4, 6, 3), **kw)
