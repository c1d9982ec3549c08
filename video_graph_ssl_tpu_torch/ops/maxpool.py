"""3D max pooling whose backward is a hand-written kernel (K3 and K4).

Counterpart of ``video_graph_ssl_tpu/ops/pallas/maxpool_kernel.py``.  The
forward is the library ``F.max_pool3d``, as the JAX kernels keep
``reduce_window`` for theirs; it saves x and y, not indices.  The backward,
on a CUDA tensor, launches ``csrc/maxpool_bwd.cu`` (two passes: first-tap
argmax into a uint8 scratch, then a gather of dy); on a CPU tensor it runs
:func:`max_pool3d_bwd_plain`, the plain PyTorch version that the tests and
``chip_smoke.py`` hold the kernel to.  There is no fallback from the kernel
to the plain version.

Ties go to the first maximal tap in t, h, w scan order, PyTorch's rule.
Both versions add the contributions to one input in increasing output
order, as PyTorch's CPU backward does, so in fp32 they agree with it bit
for bit.

Tensors are ``(B, C, T, H, W)``; the kernel takes them in
``torch.channels_last_3d`` memory, the backbone's layout.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

# Backward calls since the last reset (one call = two kernel launches):
# K3, stride-1 pools; K4, strided pools.
launches_s1 = 0
launches_strided = 0
# dy cotangents that reached the kernel in another memory format and were
# copied to channels_last_3d first.
dy_copies = 0

MAX_WINDOW = 3
_CL = torch.channels_last_3d


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        assert len(v) == 3
        return tuple(int(i) for i in v)
    return (int(v),) * 3


def _window_slices(k, s, out_shape):
    """For every tap (scan order t, h, w): the strided slices of the padded
    input that tap reads for all outputs."""
    for taps in itertools.product(*[range(ki) for ki in k]):
        yield (slice(None), slice(None)) + tuple(
            slice(a, a + si * (n - 1) + 1, si)
            for a, si, n in zip(taps, s, out_shape))


def max_pool3d_bwd_plain(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                         kernel_size, stride, padding) -> torch.Tensor:
    """Plain PyTorch version of the kernel: dx of ``y = max_pool3d(x)``.

    Each output's gradient goes to its first maximal tap; sums run in fp32
    (float64 for float64 inputs) and dx is cast to x's dtype."""
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    pads = (p[2], p[2], p[1], p[1], p[0], p[0])
    xp = F.pad(x.to(acc), pads, value=float("-inf"))
    yf = y.to(acc)
    tap = torch.full(y.shape, -1, dtype=torch.int16, device=x.device)
    slices = list(_window_slices(k, s, y.shape[2:]))
    for ti, sl in enumerate(slices):
        tap = torch.where((xp[sl] == yf) & (tap < 0), ti, tap)
    dyf = dy.to(acc)
    dxp = torch.zeros(xp.shape, dtype=acc, device=x.device)
    for ti in reversed(range(len(slices))):
        dxp[slices[ti]] += torch.where(tap == ti, dyf, 0.0)
    t, h, w = x.shape[2:]
    return dxp[:, :, p[0]:p[0] + t, p[1]:p[1] + h, p[2]:p[2] + w].to(x.dtype)


def _check(x: torch.Tensor, y: torch.Tensor, k, s, p) -> None:
    if x.dim() != 5 or y.dim() != 5:
        raise ValueError(f"max_pool3d backward: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must be (B, C, T, H, W)")
    if x.dtype not in (torch.float32, torch.bfloat16) or y.dtype != x.dtype:
        raise TypeError(f"max_pool3d backward: x {x.dtype}, y {y.dtype} "
                        "(want one of fp32, bf16)")
    if not (x.is_cuda and y.is_cuda and x.device == y.device):
        raise ValueError("max_pool3d backward: x and y must be on one CUDA device")
    if not (x.is_contiguous(memory_format=_CL) and y.is_contiguous(memory_format=_CL)):
        raise ValueError("max_pool3d backward: x and y must be channels_last_3d")
    if max(k) > MAX_WINDOW or min(k) < 1 or min(s) < 1 or min(p) < 0:
        raise ValueError(f"max_pool3d backward: window {k}, stride {s}, "
                         f"padding {p} outside the kernel's range")


def _launch(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
            k, s, p) -> torch.Tensor:
    """One backward call (two kernel launches): dx in channels_last_3d."""
    global launches_s1, launches_strided, dy_copies
    _check(x, y, k, s, p)
    if dy.shape != y.shape:
        raise ValueError(f"max_pool3d backward: dy {tuple(dy.shape)} != y "
                         f"{tuple(y.shape)}")
    dy = dy.to(y.dtype)
    if not dy.is_contiguous(memory_format=_CL):
        dy = dy.contiguous(memory_format=_CL)
        dy_copies += 1
    dx = torch.empty_like(x, memory_format=_CL)
    tap = torch.empty(y.shape, dtype=torch.uint8, device=y.device,
                      memory_format=_CL)
    b, c, t, h, w = x.shape
    to, ho, wo = y.shape[2:]
    lib = _build.library()
    code = lib.vgs_maxpool3d_bwd(
        x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr(), tap.data_ptr(),
        b, t, h, w, c, to, ho, wo, *k, *s, *p, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "vgs_maxpool3d_bwd")
    if s == (1, 1, 1):
        launches_s1 += 1
    else:
        launches_strided += 1
    return dx


class _MaxPool3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, s, p):
        y = F.max_pool3d(x, k, s, p)
        if x.is_cuda:
            y = y.contiguous(memory_format=_CL)
        ctx.save_for_backward(x, y)
        ctx.geom = (k, s, p)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        k, s, p = ctx.geom
        if x.device.type == "cpu":
            return max_pool3d_bwd_plain(x, y, dy, k, s, p), None, None, None
        return _launch(x, y, dy, k, s, p), None, None, None


def max_pool3d(x: torch.Tensor, kernel_size, stride, padding=0) -> torch.Tensor:
    """``F.max_pool3d`` (PyTorch padding semantics) with the K3/K4 backward
    on CUDA tensors and the plain backward on CPU tensors."""
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    if x.is_cuda:
        x = x.contiguous(memory_format=_CL)
    return _MaxPool3d.apply(x, k, s, p)
