"""CNN building blocks (counterpart of ``video_graph_ssl_tpu/models/layers.py``).

Layout: inside a 3D backbone, activations are ``(B, C, T, H, W)`` tensors in
``torch.channels_last_3d`` memory, i.e. the JAX package's ``(B, T, H, W, C)``
bytes; ``x.permute(0, 2, 3, 4, 1)`` is that view for free.  Inside a 2D
backbone they are ``(N, C, H, W)`` in ``torch.channels_last`` (:func:`place`
puts the parameters in the matching layouts).

Dtypes follow the JAX modules' ``dtype``/``param_dtype`` split: parameters
and batch statistics are fp32, convolutions run in the module's compute
dtype (``TPU.COMPUTE_DTYPE``), and BatchNorm normalises in fp32 and returns
the compute dtype (flax ``_normalize``).

Module and parameter names are the reference's (``base.N.conv_s``,
``branchK.J.conv``, ``bn.weight``/``running_mean``...), so state_dicts
exported from the JAX package (``export_pretrain_to_torch``) load strictly.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_sepconv, maxpool, stem_conv
from ..parallel import dist, sync_bn
from ..utils import tracing
from . import remat


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

    Under a process group of more than one rank, train mode normalises with
    the statistics of the global batch (``parallel/sync_bn.py``), as the
    JAX package's sharded step does, and every rank's running statistics
    take the same global update; ``per_rank`` (set only by
    ``sync_bn.per_rank_bn``, for ShuffleBN's key pass) keeps them local.
    :meth:`global_batch` says which of the two a train-mode pass takes.

    ``frozen`` (partial BN, :func:`freeze_bn_`): train mode normalises with
    the running statistics and leaves them as they are, as eval mode does;
    gradients still reach the scale, the bias and the input (flax
    ``use_running_average`` under the JAX package's ``bn_frozen``).

    The forward runs under a ``batch_norm`` span (``utils/tracing.py``):
    the statistics, the normalisation, the running update and the cast.
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
        self.per_rank = False
        self.sum_form = False
        self.frozen = False

    def global_batch(self) -> bool:
        """Whether train mode takes its statistics through the global-batch
        sums (ranks, or ``sync_bn.sum_form_bn``) rather than this rank's
        rows alone."""
        return not self.per_rank and (self.sum_form or dist.world_size() > 1)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``running = m * running + (1 - m) * batch``; nothing in a
        recompute (``models/remat.py``), which repeats the batch statistics
        of a forward that already took them."""
        if remat.recomputing():
            return
        m = self.momentum
        self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
        self.running_var.mul_(m).add_(var, alpha=1.0 - m)

    def forward(self, x: torch.Tensor, channel_dim: int = 1) -> torch.Tensor:
        with tracing.span("batch_norm"):
            return self._forward(x, channel_dim)

    def _forward(self, x: torch.Tensor, channel_dim: int) -> torch.Tensor:
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
        live = self.training and not self.frozen
        if live and self.global_batch():
            y, mean, var = sync_bn.SyncBatchNormFn.apply(x, w, b, self.eps, None)
            self.update_running(mean.float(), var.float())
        elif live:
            y, mean, invstd = torch.native_batch_norm(
                x, w, b, None, None, True, 0.0, self.eps)
            var = invstd.detach().double().pow(-2) - self.eps
            self.update_running(mean.float(), var.clamp_min(0.0).float())
        else:
            y = F.batch_norm(x, self.running_mean.to(pd), self.running_var.to(pd),
                             w, b, False, 0.0, self.eps)
        if last:
            y = y.movedim(1, -1)
        return y.to(out_dtype)


def conv3d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride,
           padding, dtype: torch.dtype, frames: Optional[torch.Tensor] = None,
           groups: int = 1, dilation=1) -> torch.Tensor:
    """The 3D convolution of the backbones: x (B, C, T, H, W) (its frames
    ``frames`` where given) with the fp32 parameters cast to ``dtype``, the
    JAX modules' compute dtype; ``padding`` as ``ops/maxpool.py``'s
    ``resolve_padding`` takes it (symmetric, or a ``(lo, hi)`` pair per
    axis).  Where ``stem_conv.routes`` says so (a stem on a CUDA tensor in
    bf16), the hand-written forward ``ops/stem_conv.py``; else ``F.conv3d``,
    on x zero-padded (lo, hi) first where a high pad is larger."""
    pads = maxpool.resolve_padding(padding, None, weight.shape[2:], stride)
    if stem_conv.routes(x.device, dtype, weight, groups, dilation):
        return stem_conv.stem_conv3d(x, weight, bias, stride, pads, dtype, frames)
    if frames is not None:
        x = x.index_select(2, frames)
    x, padding = stem_conv.conv_pads(x.to(dtype), pads)
    b = None if bias is None else bias.to(dtype)
    return F.conv3d(x, weight.to(dtype), b, stride, padding, dilation, groups)


def conv3d_same(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride, dtype: torch.dtype) -> torch.Tensor:
    """:func:`conv3d` with TF "SAME" padding (JAX ``nn.Conv(padding="SAME")``,
    ``lax.padtype_to_pads``): where the high side is larger (I3D's 7x7x7/2
    stem: (2, 3) at even extents) the kernel reads zero past x, and
    ``F.conv3d`` takes x zero-padded (lo, hi) first."""
    pads = maxpool.same_padding(x.shape[2:], weight.shape[2:], stride)
    return conv3d(x, weight, bias, stride, pads, dtype)


def conv(x: torch.Tensor, c: nn.Module, dtype: torch.dtype,
         frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 2D or 3D convolution ``c`` (no bias) on ``x`` in ``dtype``, the
    JAX modules' compute dtype, with fp32 parameters cast to it; a 3D one
    through :func:`conv3d` (on frames ``frames`` of x where given)."""
    if isinstance(c, nn.Conv3d):
        return conv3d(x, c.weight, None, c.stride, c.padding, dtype, frames, c.groups,
                      c.dilation)
    return F.conv2d(x.to(dtype), c.weight.to(dtype), None, c.stride, c.padding)


class BasicConv2d(nn.Module):
    """Conv2d (no bias) + BN (flax momentum 0.9) + ReLU, the unit of
    BN-Inception and Inception-v3 (JAX ``bninception.BasicConv2d``,
    ``inceptionv3.ConvBNRelu``) under the reference's ``conv``/``bn``
    names.  The reference's convs carry a bias, which the name map folds
    into the BN's running mean (``utils/torch_names.py``)."""

    def __init__(self, cin: int, cout: int, kernel_size=1, stride=1, padding=0,
                 eps: float = 1e-3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding, bias=False)
        self.bn = BatchNorm(cout, momentum=0.9, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(conv(x, self.conv, self.dtype)).to(self.dtype))


class _BoxAverage3x3(torch.autograd.Function):
    """``F.avg_pool2d(x, 3, 1, 1)`` (the padding counted, flax's
    ``count_include_pad``) whose backward is the same average of the
    cotangent: a stride-1, zero-padded 3x3 box average is its own adjoint.
    PyTorch's CUDA backward of this pool on a channels-last input with a
    contiguous cotangent returns wrong gradients (torch 2.11, CUDA 12.8,
    H100; ``chip_smoke.py`` phase 14 (b) prints its error against the
    CPU's), so the library's forward serves both directions."""

    @staticmethod
    def forward(ctx, x):
        return F.avg_pool2d(x, 3, 1, 1)

    @staticmethod
    def backward(ctx, dy):
        return F.avg_pool2d(dy, 3, 1, 1)


def avg_pool3x3(x: torch.Tensor) -> torch.Tensor:
    """The 3x3 / 1 average pool, padding 1 counted, of the 2D Inception
    nets' branch pools (:class:`_BoxAverage3x3`)."""
    return _BoxAverage3x3.apply(x)


class AvgPool3x3(nn.Module):
    """:func:`avg_pool3x3` as a module (a Sequential's parameter-free slot)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool3x3(x)


def place(module: nn.Module, device) -> nn.Module:
    """``module`` on ``device``, its 5-d tensors (3D conv kernels) in
    ``channels_last_3d`` memory and its 4-d ones (2D conv kernels) in
    ``channels_last``, the layouts of the activations they meet."""
    module = module.to(device=device)
    for t in itertools.chain(module.parameters(), module.buffers()):
        fmt = {5: torch.channels_last_3d, 4: torch.channels_last}.get(t.dim())
        if fmt is not None:
            t.data = t.data.contiguous(memory_format=fmt)
    return module


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
        y = conv3d(x, self.conv.weight, None, self.conv.stride, self.conv.padding, self.dtype)
        return F.relu(self.bn(y).to(self.dtype))


class SepConv3d(nn.Module):
    """Spatial (1,k,k)/(1,s,s) conv + BN + ReLU, then temporal (k,1,1)/(s,1,1)
    conv + BN + ReLU (reference s3d_1.py:50-69; JAX ``SepConv3d``).

    ``fused_bwd`` (``TPU.SEPCONV_FUSED``) routes a (k, s, p) == (3, 1, 1)
    instance through ``ops/fused_sepconv.py``: in train mode the pair is one
    autograd function whose backward is the three-sweep kernel K5 on CUDA
    tensors, with flax's fast-variance batch statistics, taken over the
    global batch when the pair's BNs take theirs there (ranks, or
    ``sync_bn.sum_form_bn``; ShuffleBN's key pass keeps each rank's own,
    ``sync_bn.per_rank_bn``).  Eval mode, and
    other shapes (the k=7 stem), take the standard path, which in eval mode
    is the same running-statistics composition.  So does a pair whose BNs
    are frozen (partial BN) in train mode: K5 computes the backward of
    train-mode BN, which is not that pair's function (JAX
    ``layers.py:373-395``).  The parameters and their names do not change.

    ``temporal_bias`` is S3DG's 'STConv3d' (JAX ``SepConv3d(temporal_bias=
    True)``, reference S3DG_Pytorch.py:20-43): both convs biased, the
    temporal kernel initialised Normal(0, 0.01) (:func:`init_params_`).
    Such a pair always takes the standard path: ``fused_bwd`` is ignored,
    as the JAX package gives K5 unbiased pairs only (``layers.py:327``).
    """

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.bfloat16,
                 fused_bwd: bool = False, temporal_bias: bool = False):
        super().__init__()
        k, s, p = kernel_size, stride, padding
        self.temporal_bias = bool(temporal_bias)
        self.conv_s = nn.Conv3d(cin, cout, (1, k, k), (1, s, s), (0, p, p),
                                bias=self.temporal_bias)
        self.bn_s = BatchNorm(cout, momentum=0.999, eps=1e-3)
        self.conv_t = nn.Conv3d(cout, cout, (k, 1, 1), (s, 1, 1), (p, 0, 0),
                                bias=self.temporal_bias)
        self.bn_t = BatchNorm(cout, momentum=0.999, eps=1e-3)
        self.dtype = dtype
        self.fused = (bool(fused_bwd) and not self.temporal_bias
                      and (k, s, p) == (3, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and self.training and not self.bn_s.frozen:
            return self._fused_train(x)
        dt = self.dtype
        for c, bn in ((self.conv_s, self.bn_s), (self.conv_t, self.bn_t)):
            x = F.relu(bn(conv3d(x, c.weight, c.bias, c.stride, c.padding, dt)).to(dt))
        return x

    def _fused_train(self, x: torch.Tensor) -> torch.Tensor:
        bs, bt = self.bn_s, self.bn_t
        out, (mu1, var1, mu2, var2) = fused_sepconv.fused_sepconv_train(
            x, self.conv_s.weight, self.conv_t.weight, bs.weight, bs.bias,
            bt.weight, bt.bias, self.dtype, sync=bs.global_batch())
        bs.update_running(mu1, var1)   # flax momentum, biased variance
        bt.update_running(mu2, var2)
        return out


def space_to_depth_hw(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, 4C, T, H/2, W/2), channel order (dh, dw, c)
    (JAX ``space_to_depth_hw``); the result is in ``channels_last_3d``
    memory."""
    b, c, t, h, w = x.shape
    y = x.permute(0, 2, 3, 4, 1).reshape(b, t, h // 2, 2, w // 2, 2, c)
    y = y.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, h // 2, w // 2, 4 * c)
    return y.permute(0, 4, 1, 2, 3)


def space_to_depth_t(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, 2C, T/2, H, W), channel order (dt, c) (JAX
    ``space_to_depth_t``); the result is in ``channels_last_3d`` memory."""
    b, c, t, h, w = x.shape
    y = x.permute(0, 2, 3, 4, 1).reshape(b, t // 2, 2, h, w, c)
    y = y.permute(0, 1, 3, 4, 2, 5).reshape(b, t // 2, h, w, 2 * c)
    return y.permute(0, 4, 1, 2, 3)


def fold_stem_kernel_s2d(w, axes: str) -> np.ndarray:
    """Fold a k=7 stride-2 conv kernel into its space-to-depth equivalent,
    in JAX's layout (a numpy copy of JAX ``layers.fold_stem_kernel_s2d``).

    A stride-2 pad-3 7-tap conv equals a stride-1 4-tap conv on the
    2x-space-to-depth input with pads (2, 1): output o reads input
    2o + j - 3 (tap j in 0..6); in block space that is block o + a - 2,
    phase d, with j = 2a + d - 1; only tap (a=0, d=0), j = -1, falls
    outside the 7-tap support and is zero.  The map is exact.

    ``axes='hw'``: (1,7,7,C,F) -> (1,4,4,4C,F);
    ``axes='t'``:  (7,1,1,C,F) -> (4,1,1,2C,F).
    """
    w = np.asarray(w)
    if axes == "hw":
        _, kh, kw, c, f = w.shape
        assert (kh, kw) == (7, 7), w.shape
        out = np.zeros((1, 4, 4, 4 * c, f), w.dtype)
        for a in range(4):
            for dh in range(2):
                jh = 2 * a + dh - 1
                if not 0 <= jh < 7:
                    continue
                for bb in range(4):
                    for dw in range(2):
                        jw = 2 * bb + dw - 1
                        if not 0 <= jw < 7:
                            continue
                        ch = (dh * 2 + dw) * c
                        out[0, a, bb, ch:ch + c] = w[0, jh, jw]
        return out
    assert axes == "t"
    kd, _, _, c, f = w.shape
    assert kd == 7, w.shape
    out = np.zeros((4, 1, 1, 2 * c, f), w.dtype)
    for a in range(4):
        for dt in range(2):
            j = 2 * a + dt - 1
            if not 0 <= j < 7:
                continue
            out[a, 0, 0, dt * c:(dt + 1) * c] = w[j, 0, 0]
    return out


def fold_stem_weight(w: torch.Tensor, axes: str) -> torch.Tensor:
    """:func:`fold_stem_kernel_s2d` on a torch conv weight (F, C, kt, kh,
    kw): transposed to JAX's (kt, kh, kw, C, F), folded, transposed back;
    same dtype, on the CPU."""
    src = w.detach().cpu()
    if src.dtype == torch.bfloat16:     # numpy has no bf16; the fold only copies
        src = src.float()
    folded = fold_stem_kernel_s2d(src.permute(2, 3, 4, 1, 0).numpy(), axes)
    return torch.from_numpy(np.ascontiguousarray(folded.transpose(4, 3, 0, 1, 2))).to(w.dtype)


class SepConvS2D(nn.Module):
    """The space-to-depth S3D stem (``TPU.STEM_S2D``; JAX ``SepConvS2D``):
    ``SepConv3d(cin, cout, 7, 2, 3)`` as two stride-1 convs on
    space-to-depth inputs, the same function under the
    :func:`fold_stem_kernel_s2d` weight map.  The spatial conv is (1, 4, 4)
    with pads (2, 1) on the 4C-channel input; the temporal conv is (4, 1, 1)
    with pads (2, 1) on the 2 x cout-channel input (``temporal_s2d``, mode
    ``full``), or the standard (7, 1, 1) / 2 (mode ``spatial``).  BNs, ReLUs
    and names are :class:`SepConv3d`'s (``conv_s``, ``bn_s``, ``conv_t``,
    ``bn_t``); ``temporal_bias`` is S3DG's biased pair, the temporal kernel
    initialised Normal(0, 0.01) (:func:`init_params_`).  T, H and W must be
    even, as JAX asserts.  The convolutions are the library's (JAX runs
    them outside Pallas)."""

    def __init__(self, cin: int, cout: int, temporal_bias: bool = False,
                 temporal_s2d: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.temporal_bias = bool(temporal_bias)
        self.temporal_s2d = bool(temporal_s2d)
        self.conv_s = nn.Conv3d(4 * cin, cout, (1, 4, 4), bias=self.temporal_bias)
        self.bn_s = BatchNorm(cout, momentum=0.999, eps=1e-3)
        if self.temporal_s2d:
            self.conv_t = nn.Conv3d(2 * cout, cout, (4, 1, 1), bias=self.temporal_bias)
        else:
            self.conv_t = nn.Conv3d(cout, cout, (7, 1, 1), (2, 1, 1), (3, 0, 0),
                                    bias=self.temporal_bias)
        self.bn_t = BatchNorm(cout, momentum=0.999, eps=1e-3)
        self.dtype = dtype

    def _convbn(self, x, conv, bn, pad=None):
        dt = self.dtype
        x = x.to(dt)
        if pad is not None:
            x = F.pad(x, pad).contiguous(memory_format=torch.channels_last_3d)
        bias = None if conv.bias is None else conv.bias.to(dt)
        y = F.conv3d(x, conv.weight.to(dt), bias, conv.stride, conv.padding)
        return F.relu(bn(y).to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t, h, w = x.shape[2:]
        if t % 2 or h % 2 or w % 2:
            raise ValueError(f"SepConvS2D needs even T, H, W; got {tuple(x.shape)} "
                             "(B, C, T, H, W)")
        x = self._convbn(space_to_depth_hw(x), self.conv_s, self.bn_s, (2, 1, 2, 1))
        if self.temporal_s2d:
            return self._convbn(space_to_depth_t(x), self.conv_t, self.bn_t,
                                (0, 0, 0, 0, 2, 1))
        return self._convbn(x, self.conv_t, self.bn_t)


class MaxPool3d(nn.Module):
    """3D max pooling (``ops/maxpool.py``: on CUDA tensors the forward is
    the hand-written y-only kernel, ``csrc/maxpool_fwd.cu``, and the
    backward kernel K3 for stride-1 pools and K4 for strided ones; on CPU
    tensors the library's forward and the plain backward).
    ``padding``: PyTorch's symmetric padding (an int or one per axis),
    ``(lo, hi)`` pairs, or ``"SAME"`` (TF padding, resolved per input:
    I3D's pools, JAX ``nn.max_pool(padding="SAME")``).

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
        self.padding = padding if isinstance(padding, str) else maxpool.resolve_padding(
            padding, None, self.kernel_size, self.stride)

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
    (``TPU.SEPCONV_FUSED``) sets ``fused_bwd`` on both branch SepConvs,
    ``temporal_bias`` (S3DG) makes them biased.  ``unit`` (I3D's
    ``Unit3D``, a ``BasicConv3d`` with TF "SAME" padding) makes every conv
    of the block one of its kind, the branch convs full 3x3x3 ones, and
    the branch pool "SAME", which pads (1, 1) as S3D's does (JAX
    ``I3DMixed``)."""

    def __init__(self, cin: int, b0: int, b1: Sequence[int], b2: Sequence[int],
                 b3: int, dtype: torch.dtype = torch.bfloat16,
                 fused_sepconv: bool = False, temporal_bias: bool = False,
                 unit: Optional[type] = None):
        super().__init__()
        pw = unit or BasicConv3d

        def mid(c_in, c_out):
            if unit is not None:
                return unit(c_in, c_out, 3, dtype=dtype)
            return SepConv3d(c_in, c_out, 3, 1, 1, fused_bwd=fused_sepconv,
                             temporal_bias=temporal_bias, dtype=dtype)

        self.branch0 = nn.Sequential(pw(cin, b0, 1, dtype=dtype))
        self.branch1 = nn.Sequential(pw(cin, b1[0], 1, dtype=dtype), mid(b1[0], b1[1]))
        self.branch2 = nn.Sequential(pw(cin, b2[0], 1, dtype=dtype), mid(b2[0], b2[1]))
        self.branch3 = nn.Sequential(MaxPool3d(3, 1, 1 if unit is None else "SAME"),
                                     pw(cin, b3, 1, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], dim=1)

    @staticmethod
    def out_channels(b0: int, b1: Sequence[int], b2: Sequence[int], b3: int) -> int:
        return b0 + b1[1] + b2[1] + b3


def freeze_bn_(module: nn.Module) -> None:
    """Partial BN: freeze every :class:`BatchNorm` of ``module`` outside its
    graph blocks, whose BNs the JAX package runs in train mode."""
    from ..ops.temporal_graph import TemporalGraphAug

    graph = {id(b) for m in module.modules() if isinstance(m, TemporalGraphAug)
             for b in m.modules()}
    for m in module.modules():
        if isinstance(m, BatchNorm) and id(m) not in graph:
            m.frozen = True


@torch.no_grad()
def init_params_(module: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """The JAX init: lecun-normal conv/linear kernels, except fan-in uniform
    for the graph blocks' 1x1x1 convs and Normal(0, 0.01) for the temporal
    convs of biased (S3DG) SepConv pairs; zero biases; BN scale 1, bias 0."""
    from ..ops.temporal_graph import TemporalGraphAug

    graph = set()
    for m in module.modules():
        if isinstance(m, TemporalGraphAug):
            graph.update(id(p) for p in m.parameters())
    for m in module.modules():
        if isinstance(m, (nn.Conv3d, nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            init = fanin_uniform_ if id(m.weight) in graph else lecun_normal_
            init(m.weight, fan_in, generator)
            if m.bias is not None:
                m.bias.zero_()
    for m in module.modules():
        if isinstance(m, (SepConv3d, SepConvS2D)) and m.temporal_bias:
            nn.init.normal_(m.conv_t.weight, 0.0, 0.01, generator=generator)
