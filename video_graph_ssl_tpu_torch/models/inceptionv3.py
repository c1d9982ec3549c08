"""Inception-v3, counterpart of ``video_graph_ssl_tpu/models/inceptionv3.py``
(the reference's backbone_2d/inceptionv3.py:51-352: the A-E block
families, a valid-padded stem, 299x299 native input (75x75 the least),
feature dim 2048; no aux head).

Frames arrive as ``(N, H, W, C)`` and run as ``(N, C, H, W)`` views in
``channels_last`` memory.  Every conv is ``layers.BasicConv2d`` (no bias,
BN with flax momentum 0.9 and eps 1e-3, ReLU) under the reference's names
(``Conv2d_1a_3x3``, ``Mixed_6b.branch7x7_2``, ...; its conv biases fold into
the BN's running mean, ``utils/torch_names.py``).  The kernel orientations
are the reference's, which swap torchvision's in the C, D and E blocks:
``branch7x7_2`` is (7, 1) then ``branch7x7_3`` (1, 7), the double branch
starts with (1, 7), and E's ``_2a``/``_3a`` are (3, 1) (JAX
``inceptionv3.py:83, 110, 126``).  The branch pools are 3x3/1 average pools
padded 1 that count the padding (flax's default; ``layers.avg_pool3x3``),
the reductions' 3x3/2 max pools valid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BasicConv2d, avg_pool3x3, freeze_bn_

INCEPTIONV3_FEATURE_DIM = 2048
EPS = 1e-3


def _cbr(cin: int, cout: int, kernel=1, stride=1, padding=0, dtype=torch.bfloat16):
    return BasicConv2d(cin, cout, kernel, stride, padding, eps=EPS, dtype=dtype)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, dtype: torch.dtype):
        super().__init__()
        kw = dict(dtype=dtype)
        self.branch1x1 = _cbr(cin, 64, **kw)
        self.branch5x5_1 = _cbr(cin, 48, **kw)
        self.branch5x5_2 = _cbr(48, 64, 5, padding=2, **kw)
        self.branch3x3dbl_1 = _cbr(cin, 64, **kw)
        self.branch3x3dbl_2 = _cbr(64, 96, 3, padding=1, **kw)
        self.branch3x3dbl_3 = _cbr(96, 96, 3, padding=1, **kw)
        self.branch_pool = _cbr(cin, pool_features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(avg_pool3x3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, dtype: torch.dtype):
        super().__init__()
        kw = dict(dtype=dtype)
        self.branch3x3 = _cbr(cin, 384, 3, 2, **kw)
        self.branch3x3dbl_1 = _cbr(cin, 64, **kw)
        self.branch3x3dbl_2 = _cbr(64, 96, 3, padding=1, **kw)
        self.branch3x3dbl_3 = _cbr(96, 96, 3, 2, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, dtype: torch.dtype):
        super().__init__()
        kw = dict(dtype=dtype)
        self.branch1x1 = _cbr(cin, 192, **kw)
        self.branch7x7_1 = _cbr(cin, c7, **kw)
        self.branch7x7_2 = _cbr(c7, c7, (7, 1), padding=(3, 0), **kw)
        self.branch7x7_3 = _cbr(c7, 192, (1, 7), padding=(0, 3), **kw)
        self.branch7x7dbl_1 = _cbr(cin, c7, **kw)
        self.branch7x7dbl_2 = _cbr(c7, c7, (1, 7), padding=(0, 3), **kw)
        self.branch7x7dbl_3 = _cbr(c7, c7, (7, 1), padding=(3, 0), **kw)
        self.branch7x7dbl_4 = _cbr(c7, c7, (1, 7), padding=(0, 3), **kw)
        self.branch7x7dbl_5 = _cbr(c7, 192, (7, 1), padding=(3, 0), **kw)
        self.branch_pool = _cbr(cin, 192, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(avg_pool3x3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, dtype: torch.dtype):
        super().__init__()
        kw = dict(dtype=dtype)
        self.branch3x3_1 = _cbr(cin, 192, **kw)
        self.branch3x3_2 = _cbr(192, 320, 3, 2, **kw)
        self.branch7x7x3_1 = _cbr(cin, 192, **kw)
        self.branch7x7x3_2 = _cbr(192, 192, (7, 1), padding=(3, 0), **kw)
        self.branch7x7x3_3 = _cbr(192, 192, (1, 7), padding=(0, 3), **kw)
        self.branch7x7x3_4 = _cbr(192, 192, 3, 2, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, dtype: torch.dtype):
        super().__init__()
        kw = dict(dtype=dtype)
        self.branch1x1 = _cbr(cin, 320, **kw)
        self.branch3x3_1 = _cbr(cin, 384, **kw)
        self.branch3x3_2a = _cbr(384, 384, (3, 1), padding=(1, 0), **kw)
        self.branch3x3_2b = _cbr(384, 384, (1, 3), padding=(0, 1), **kw)
        self.branch3x3dbl_1 = _cbr(cin, 448, **kw)
        self.branch3x3dbl_2 = _cbr(448, 384, 3, padding=1, **kw)
        self.branch3x3dbl_3a = _cbr(384, 384, (3, 1), padding=(1, 0), **kw)
        self.branch3x3dbl_3b = _cbr(384, 384, (1, 3), padding=(0, 1), **kw)
        self.branch_pool = _cbr(cin, 192, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(avg_pool3x3(x))], dim=1)


STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1", "Conv2d_4a_3x3")
MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
         "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c")


class InceptionV3(nn.Module):
    """Frames (N, H, W, 3), H and W at least 75 -> (N, 2048) fp32
    spatial-mean features.  ``partial_bn`` freezes every BN after
    ``Conv2d_1a_3x3``'s."""

    feature_dim = INCEPTIONV3_FEATURE_DIM

    def __init__(self, partial_bn: bool = False, dtype: torch.dtype = torch.bfloat16,
                 in_channels: int = 3):
        super().__init__()
        kw = dict(dtype=dtype)
        self.Conv2d_1a_3x3 = _cbr(in_channels, 32, 3, 2, **kw)
        self.Conv2d_2a_3x3 = _cbr(32, 32, 3, **kw)
        self.Conv2d_2b_3x3 = _cbr(32, 64, 3, padding=1, **kw)
        self.Conv2d_3b_1x1 = _cbr(64, 80, **kw)
        self.Conv2d_4a_3x3 = _cbr(80, 192, 3, **kw)
        self.Mixed_5b = InceptionA(192, 32, dtype)
        self.Mixed_5c = InceptionA(256, 64, dtype)
        self.Mixed_5d = InceptionA(288, 64, dtype)
        self.Mixed_6a = InceptionB(288, dtype)
        self.Mixed_6b = InceptionC(768, 128, dtype)
        self.Mixed_6c = InceptionC(768, 160, dtype)
        self.Mixed_6d = InceptionC(768, 160, dtype)
        self.Mixed_6e = InceptionC(768, 192, dtype)
        self.Mixed_7a = InceptionD(768, dtype)
        self.Mixed_7b = InceptionE(1280, dtype)
        self.Mixed_7c = InceptionE(2048, dtype)
        self.dtype = dtype
        if partial_bn:
            for name, m in self.named_children():
                if name != "Conv2d_1a_3x3":
                    freeze_bn_(m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i, name in enumerate(STEM):
            x = getattr(self, name)(x)
            if i in (2, 4):
                x = F.max_pool2d(x, 3, 2)
        for name in MIXED:
            x = getattr(self, name)(x)
        return x.float().mean(dim=(2, 3))


def inception_v3(aug_points=(), graph_cfg=None, **kw) -> InceptionV3:
    # graph blocks are a 3D-path feature: JAX's constructor drops them
    return InceptionV3(**kw)
