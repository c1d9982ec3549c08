"""3D-CNN building blocks (counterpart of ``video_graph_ssl_tpu/models/layers.py``).

Layout: inside a backbone, activations are ``(B, C, T, H, W)`` tensors in
``torch.channels_last_3d`` memory, i.e. the JAX package's ``(B, T, H, W, C)``
bytes; ``x.permute(0, 2, 3, 4, 1)`` is that view for free.

Dtypes follow the JAX modules' ``dtype``/``param_dtype`` split: parameters
and batch statistics are fp32, convolutions run in the module's compute
dtype (``TPU.COMPUTE_DTYPE``), and BatchNorm normalises in fp32 and returns
the compute dtype (flax ``_normalize``).

Module and parameter names are the reference's (``base.N.conv_s``,
``branchK.J.conv``, ``bn.weight``/``running_mean``...), so state_dicts
exported from the JAX package (``export_pretrain_to_torch``) load strictly.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        assert len(v) == 3
        return tuple(int(i) for i in v)
    return (int(v),) * 3


# flax lecun_normal: variance_scaling(1, 'fan_in', 'truncated_normal') --
# a normal truncated at +-2 std, rescaled so its std is 1/sqrt(fan_in).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def fanin_uniform_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return nn.init.uniform_(w, -bound, bound, generator=generator)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` semantics on a channel dimension.

    Train mode normalises with the biased batch variance and updates
    ``running = m * running + (1 - m) * batch`` with the flax momentum ``m``
    (0.999 for the backbone == torch momentum 0.001) and the *biased*
    variance, which torch's own running-stat update does not use.  The
    normalisation runs in fp32; the output is cast to ``dtype`` (or stays in
    the input dtype when ``dtype`` is None).
    """

    def __init__(self, num_features: int, momentum: float, eps: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, channel_dim: int = 1) -> torch.Tensor:
        out_dtype = self.dtype or x.dtype
        if channel_dim not in (1, x.dim() - 1, -1):
            raise ValueError(f"channel_dim {channel_dim} for a {x.dim()}-d input")
        last = channel_dim in (-1, x.dim() - 1) and x.dim() > 2
        if last:   # (..., C): BN over the trailing channel dim
            x = x.movedim(-1, 1)
        # fp32 parameters serve fp32/bf16 inputs; a float64 input (CPU
        # parity tests) gets float64 parameters
        pd = torch.float64 if x.dtype == torch.float64 else torch.float32
        w, b = self.weight.to(pd), self.bias.to(pd)
        if self.training:
            y, mean, invstd = torch.native_batch_norm(
                x, w, b, None, None, True, 0.0, self.eps)
            with torch.no_grad():
                var = invstd.double().pow(-2) - self.eps
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.float(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.clamp_min(0.0).float(),
                                              alpha=1.0 - m)
        else:
            y = F.batch_norm(x, self.running_mean.to(pd), self.running_var.to(pd),
                             w, b, False, 0.0, self.eps)
        if last:
            y = y.movedim(1, -1)
        return y.to(out_dtype)


class BasicConv3d(nn.Module):
    """Conv3d (no bias) + BN(eps 1e-3, flax momentum 0.999) + ReLU
    (reference s3d_1.py:37-48; JAX ``BasicConv3d``)."""

    def __init__(self, cin: int, cout: int, kernel_size=1, stride=1,
                 padding=0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, _triple(kernel_size), _triple(stride),
                              _triple(padding), bias=False)
        self.bn = BatchNorm(cout, momentum=0.999, eps=1e-3)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        y = F.conv3d(x.to(self.dtype), c.weight.to(self.dtype), None,
                     c.stride, c.padding)
        return F.relu(self.bn(y).to(self.dtype))


class SepConv3d(nn.Module):
    """Spatial (1,k,k)/(1,s,s) conv + BN + ReLU, then temporal (k,1,1)/(s,1,1)
    conv + BN + ReLU (reference s3d_1.py:50-69; JAX ``SepConv3d``)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        k, s, p = kernel_size, stride, padding
        self.conv_s = nn.Conv3d(cin, cout, (1, k, k), (1, s, s), (0, p, p),
                                bias=False)
        self.bn_s = BatchNorm(cout, momentum=0.999, eps=1e-3)
        self.conv_t = nn.Conv3d(cout, cout, (k, 1, 1), (s, 1, 1), (p, 0, 0),
                                bias=False)
        self.bn_t = BatchNorm(cout, momentum=0.999, eps=1e-3)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        for conv, bn in ((self.conv_s, self.bn_s), (self.conv_t, self.bn_t)):
            x = F.conv3d(x.to(dt), conv.weight.to(dt), None, conv.stride,
                         conv.padding)
            x = F.relu(bn(x).to(dt))
        return x


class MaxPool3d(nn.Module):
    """3D max pooling with PyTorch padding semantics.

    The JAX package's stride-1 pools are a separable ``where(>=)`` chain and
    its strided pools ``reduce_window``; both have this forward.  Gradients
    differ only where a window holds tied maxima (torch routes the gradient
    to the first maximum in t, h, w scan order); inside the network such
    ties are almost always ReLU zeros, whose upstream ReLU gradient is 0.
    """

    def __init__(self, kernel_size, stride, padding=0):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.stride = _triple(stride)
        self.padding = _triple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding)


def max_pool_3d(x: torch.Tensor, kernel_size, stride, padding=0) -> torch.Tensor:
    return F.max_pool3d(x, _triple(kernel_size), _triple(stride),
                        _triple(padding))


class InceptionBlock(nn.Module):
    """S3D Inception block (reference s3d_1.py:71-329 ``Mixed_*``; JAX
    ``InceptionBlock``): 1x1x1 | 1x1x1 -> SepConv | 1x1x1 -> SepConv |
    3x3x3 max pool -> 1x1x1, concatenated on channels.  The JAX
    ``TPU.PACK_POINTWISE`` packing is the same math on the same parameters,
    so the three 1x1x1 convs stay separate here."""

    def __init__(self, cin: int, b0: int, b1: Sequence[int], b2: Sequence[int],
                 b3: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        kw = dict(dtype=dtype)
        self.branch0 = nn.Sequential(BasicConv3d(cin, b0, 1, **kw))
        self.branch1 = nn.Sequential(BasicConv3d(cin, b1[0], 1, **kw),
                                     SepConv3d(b1[0], b1[1], 3, 1, 1, **kw))
        self.branch2 = nn.Sequential(BasicConv3d(cin, b2[0], 1, **kw),
                                     SepConv3d(b2[0], b2[1], 3, 1, 1, **kw))
        self.branch3 = nn.Sequential(MaxPool3d(3, 1, 1),
                                     BasicConv3d(cin, b3, 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], dim=1)

    @staticmethod
    def out_channels(b0: int, b1: Sequence[int], b2: Sequence[int], b3: int) -> int:
        return b0 + b1[1] + b2[1] + b3


@torch.no_grad()
def init_params_(module: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """The JAX init: lecun-normal conv/linear kernels, except fan-in uniform
    for the graph blocks' 1x1x1 convs; zero biases; BN scale 1, bias 0."""
    from ..ops.temporal_graph import TemporalGraphAug

    graph = set()
    for m in module.modules():
        if isinstance(m, TemporalGraphAug):
            graph.update(id(p) for p in m.parameters())
    for m in module.modules():
        if isinstance(m, (nn.Conv3d, nn.Linear)):
            fan_in = m.weight[0].numel()
            init = fanin_uniform_ if id(m.weight) in graph else lecun_normal_
            init(m.weight, fan_in, generator)
            if m.bias is not None:
                m.bias.zero_()
