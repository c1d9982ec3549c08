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

from ..ops import fused_sepconv, maxpool


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
    conv + BN + ReLU (reference s3d_1.py:50-69; JAX ``SepConv3d``).

    ``fused_bwd`` (``TPU.SEPCONV_FUSED``) routes a (k, s, p) == (3, 1, 1)
    instance through ``ops/fused_sepconv.py``: in train mode the pair is one
    autograd function whose backward is the three-sweep kernel K5 on CUDA
    tensors, with flax's fast-variance batch statistics.  Eval mode, and
    other shapes (the k=7 stem), take the standard path, which in eval mode
    is the same running-statistics composition.  The parameters and their
    names do not change.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.bfloat16,
                 fused_bwd: bool = False):
        super().__init__()
        k, s, p = kernel_size, stride, padding
        self.conv_s = nn.Conv3d(cin, cout, (1, k, k), (1, s, s), (0, p, p),
                                bias=False)
        self.bn_s = BatchNorm(cout, momentum=0.999, eps=1e-3)
        self.conv_t = nn.Conv3d(cout, cout, (k, 1, 1), (s, 1, 1), (p, 0, 0),
                                bias=False)
        self.bn_t = BatchNorm(cout, momentum=0.999, eps=1e-3)
        self.dtype = dtype
        self.fused = bool(fused_bwd) and (k, s, p) == (3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and self.training:
            return self._fused_train(x)
        dt = self.dtype
        for conv, bn in ((self.conv_s, self.bn_s), (self.conv_t, self.bn_t)):
            x = F.conv3d(x.to(dt), conv.weight.to(dt), None, conv.stride,
                         conv.padding)
            x = F.relu(bn(x).to(dt))
        return x

    def _fused_train(self, x: torch.Tensor) -> torch.Tensor:
        bs, bt = self.bn_s, self.bn_t
        out, (mu1, var1, mu2, var2) = fused_sepconv.fused_sepconv_train(
            x, self.conv_s.weight, self.conv_t.weight, bs.weight, bs.bias,
            bt.weight, bt.bias, self.dtype)
        with torch.no_grad():   # flax momentum, biased variance
            for bn, mu, var in ((bs, mu1, var1), (bt, mu2, var2)):
                m = bn.momentum
                bn.running_mean.mul_(m).add_(mu, alpha=1.0 - m)
                bn.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return out


class MaxPool3d(nn.Module):
    """3D max pooling with PyTorch padding semantics (``ops/maxpool.py``:
    library forward; on CUDA tensors the backward is kernel K3 for stride-1
    pools and K4 for strided ones).

    The JAX package's stride-1 pools are a separable ``where(>=)`` chain and
    its strided pools ``reduce_window``; both have this forward.  The port
    sends a tied window's gradient to its first maximum in t, h, w scan
    order (PyTorch's rule and the JAX K4 kernel's); the JAX where-chain
    routes ties axis by axis and the JAX K3 kernel splits them among all
    maxima.  All of these agree wherever the window max is unique; inside
    the network ties are almost always ReLU zeros, whose upstream ReLU
    gradient is 0.
    """

    def __init__(self, kernel_size, stride, padding=0):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.stride = _triple(stride)
        self.padding = _triple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return maxpool.max_pool3d(x, self.kernel_size, self.stride, self.padding)


def max_pool_3d(x: torch.Tensor, kernel_size, stride, padding=0) -> torch.Tensor:
    return maxpool.max_pool3d(x, kernel_size, stride, padding)


class InceptionBlock(nn.Module):
    """S3D Inception block (reference s3d_1.py:71-329 ``Mixed_*``; JAX
    ``InceptionBlock``): 1x1x1 | 1x1x1 -> SepConv | 1x1x1 -> SepConv |
    3x3x3 max pool -> 1x1x1, concatenated on channels.  The JAX
    ``TPU.PACK_POINTWISE`` packing is the same math on the same parameters,
    so the three 1x1x1 convs stay separate here.  ``fused_sepconv``
    (``TPU.SEPCONV_FUSED``) sets ``fused_bwd`` on both branch SepConvs."""

    def __init__(self, cin: int, b0: int, b1: Sequence[int], b2: Sequence[int],
                 b3: int, dtype: torch.dtype = torch.bfloat16,
                 fused_sepconv: bool = False):
        super().__init__()
        kw = dict(dtype=dtype)
        sep = dict(fused_bwd=fused_sepconv, **kw)
        self.branch0 = nn.Sequential(BasicConv3d(cin, b0, 1, **kw))
        self.branch1 = nn.Sequential(BasicConv3d(cin, b1[0], 1, **kw),
                                     SepConv3d(b1[0], b1[1], 3, 1, 1, **sep))
        self.branch2 = nn.Sequential(BasicConv3d(cin, b2[0], 1, **kw),
                                     SepConv3d(b2[0], b2[1], 3, 1, 1, **sep))
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
