"""Plain building blocks of the reference models: float32 PyTorch, no
kernel, no cache, no layout trick.

Every convolution and every product that the measured program runs in its
compute dtype goes through :class:`Rounding`.  The reference itself rounds
nothing (``Rounding(None)``); the control of the benchmark's check rounds
both operands of each such product to float8 (e4m3, per-tensor scale), the
nearest precision below the bfloat16 that the configurations state, and the
gradients that flow back through them to float8 e5m2, as fp8 training does.

Module and parameter names follow the measured program's (and the original
PyTorch code's), so that one state dict made by the benchmark loads into both.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# float8 formats of fp8 training: e4m3 for values, e5m2 for gradients
FP8_FORMATS = {"value": (torch.float8_e4m3fn, 448.0), "grad": (torch.float8_e5m2, 57344.0)}


def _scaled_round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` in ``dtype`` under a per-tensor scale that maps its largest
    magnitude to ``top``, back in ``x``'s dtype."""
    amax = x.abs().amax().float().clamp_min(1e-30)
    scale = amax / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Round(torch.autograd.Function):
    """Round a value on the way in and its gradient on the way back: to
    bfloat16 both, or to float8 e4m3 and e5m2 with per-tensor scales."""

    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        if mode == "bf16":
            return x.to(torch.bfloat16).to(x.dtype)
        return _scaled_round(x, *FP8_FORMATS["value"])

    @staticmethod
    def backward(ctx, g):
        if ctx.mode == "bf16":
            return g.to(torch.bfloat16).to(g.dtype), None
        return _scaled_round(g, *FP8_FORMATS["grad"]), None


class Rounding:
    """What the products of a reference model see: ``None`` (float32, the
    reference), ``"fp8"`` (the control) or ``"bf16"`` (the configurations'
    own precision, a witness for the calibration)."""

    def __init__(self, mode: Optional[str] = None):
        if mode not in (None, "fp8", "bf16"):
            raise ValueError(f"unknown rounding {mode!r}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode is None or x.device.type == "meta":
            return x
        return _Round.apply(x, self.mode)


def conv3d(x: torch.Tensor, m: nn.Conv3d, r: Rounding) -> torch.Tensor:
    return F.conv3d(r(x), r(m.weight), None if m.bias is None else m.bias,
                    m.stride, m.padding)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           r: Rounding) -> torch.Tensor:
    return F.linear(r(x), r(weight), bias)


def bmm(a: torch.Tensor, b: torch.Tensor, r: Rounding) -> torch.Tensor:
    return torch.bmm(r(a), r(b))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm``: train mode normalises with the batch mean and
    the biased batch variance and updates ``running = m * running + (1 - m)
    * batch`` (biased variance); eval mode uses the running statistics.
    ``channel_dim`` 1 or -1."""

    def __init__(self, num_features: int, momentum: float, eps: float):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, channel_dim: int = 1) -> torch.Tensor:
        if channel_dim != 1:
            x = x.movedim(channel_dim, 1)
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.training:
            mean = x.mean(dim=dims)
            var = (x - mean.reshape(shape)).square().mean(dim=dims)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y.movedim(1, channel_dim) if channel_dim != 1 else y


class MaxPool3d(nn.Module):
    """``F.max_pool3d`` with symmetric padding (no parameters)."""

    def __init__(self, kernel_size, stride, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)).clamp_min(eps)
