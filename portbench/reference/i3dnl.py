"""I3D-ResNet-50 with non-local blocks (after Wang et al., CVPR 2018) and
GCA graph blocks, plain float32, as the original code's ``i3dnon.py`` is
built by the measured program: a (5, 7, 7) / 2 stem, a 3x3x3 / 2 max pool,
(3, 4, 6, 3) inflated bottlenecks at widths 64-2048 (temporal kernel 3 on
block 0 and the odd blocks, stride 2 in H and W at the first block of
stages 2-4), a (3, 1, 1) / (2, 1, 1) max pool after layer1, embedded-
Gaussian non-local blocks at layer2.1 and layer2.3, graph blocks on the
inputs of stages 2, 3 and 4; BN eps 1e-5, flax momentum 0.9; the features
are the last stage's mean over T, H and W.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .graph import TemporalGraphAug, stage_seed
from .nn import BatchNorm, MaxPool3d, Rounding, bmm, conv3d, linear

FEATURE_DIM = 2048
LAYERS = (3, 4, 6, 3)


def bn(c: int) -> BatchNorm:
    return BatchNorm(c, 0.9, 1e-5)


class NonLocalBlock3D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        inter = max(c // 2, 1)
        self.theta, self.phi, self.g = nn.Linear(c, inter), nn.Linear(c, inter), nn.Linear(c, inter)
        self.w_out = nn.Linear(inter, c)
        self.w_bn = bn(c)
        self.rounding = Rounding()

    def _dense(self, x, m):
        return linear(x, m.weight, m.bias, self.rounding)

    @staticmethod
    def _pooled(h: torch.Tensor) -> torch.Tensor:
        b, t, hh, ww, c = h.shape
        h = F.max_pool2d(h.reshape(b * t, hh, ww, c).permute(0, 3, 1, 2), 2, 2)
        return h.permute(0, 2, 3, 1).reshape(b, -1, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.rounding
        xc = x.permute(0, 2, 3, 4, 1)
        b, t, h, w, _ = xc.shape
        theta = self._dense(xc, self.theta).reshape(b, t * h * w, -1)
        phi = self._pooled(self._dense(xc, self.phi))
        g = self._pooled(self._dense(xc, self.g))
        attn = torch.softmax(bmm(theta, phi.transpose(1, 2), r), dim=-1)
        y = bmm(attn, g, r).reshape(b, t, h, w, -1)
        y = self.w_bn(self._dense(y, self.w_out), channel_dim=-1)
        return x + y.permute(0, 4, 1, 2, 3)


class InflatedBottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, tk: int, stride: int, add_nonlocal: bool):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, planes, (tk, 1, 1), 1, ((tk - 1) // 2, 0, 0), bias=False)
        self.bn1 = bn(planes)
        self.conv2 = nn.Conv3d(planes, planes, (1, 3, 3), (1, stride, stride), (0, 1, 1),
                               bias=False)
        self.bn2 = bn(planes)
        self.conv3 = nn.Conv3d(planes, planes * 4, 1, bias=False)
        self.bn3 = bn(planes * 4)
        self.downsample = None
        if stride != 1 or cin != planes * 4:
            self.downsample = nn.Sequential(
                nn.Conv3d(cin, planes * 4, 1, (1, stride, stride), bias=False), bn(planes * 4))
        self.non_local = NonLocalBlock3D(planes * 4) if add_nonlocal else None
        self.rounding = Rounding()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.rounding
        out = F.relu(self.bn1(conv3d(x, self.conv1, r)))
        out = F.relu(self.bn2(conv3d(out, self.conv2, r)))
        out = self.bn3(conv3d(out, self.conv3, r))
        res = x if self.downsample is None else self.downsample[1](
            conv3d(x, self.downsample[0], r))
        out = F.relu(out + res)
        return out if self.non_local is None else self.non_local(out)


class I3DResNetNonLocal(nn.Module):
    """(B, T, H, W, 3) clips -> (B, 2048) features."""

    feature_dim = FEATURE_DIM

    def __init__(self, aug_points=(2, 3, 4)):
        super().__init__()
        self.conv1 = nn.Conv3d(3, 64, (5, 7, 7), 2, (2, 3, 3), bias=False)
        self.bn1 = bn(64)
        self.rounding = Rounding()
        self.pool1 = MaxPool3d(3, 2, 1)
        self.pool_t = MaxPool3d((3, 1, 1), (2, 1, 1), (1, 0, 0))
        self.aug_points = tuple(aug_points)
        cin = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), LAYERS), start=1):
            blocks = [InflatedBottleneck(cin if b == 0 else planes * 4, planes,
                                         3 if (b == 0 or b % 2 == 1) else 1,
                                         2 if (b == 0 and stage > 1) else 1,
                                         n in (4, 23) and b > 0 and b % 2 == 1)
                      for b in range(n)]
            layer = nn.Sequential(*blocks)
            if stage in self.aug_points:
                layer = nn.Sequential(TemporalGraphAug(cin), layer)
            setattr(self, f"layer{stage}", layer)
            cin = planes * 4

    def forward(self, x: torch.Tensor, graph_seed: int) -> torch.Tensor:
        x = F.relu(self.bn1(conv3d(x.permute(0, 4, 1, 2, 3), self.conv1, self.rounding)))
        x = self.pool1(x)
        for stage in range(1, 5):
            layer = getattr(self, f"layer{stage}")
            if stage in self.aug_points:
                graph, layer = layer[0], layer[1]
                y = graph(x.permute(0, 2, 3, 4, 1), stage_seed(graph_seed, stage))
                x = y.permute(0, 4, 1, 2, 3)
            x = layer(x)
            if stage == 1:
                x = self.pool_t(x)
        return x.mean(dim=(2, 3, 4))
