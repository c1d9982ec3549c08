"""SlowFast-R50, 8x8 (Feichtenhofer et al., ICCV 2019, arXiv 1812.03982) with
GCA graph blocks on its Fast pathway, plain float32, as PySlowFast's
``configs/Kinetics/SLOWFAST_8x8_R50.yaml`` builds it and as the measured
program names it.

Slow takes frames ``linspace(0, T - 1, T / 4)`` (truncated) of the clip,
Fast all of them.  Stems: Slow 1x7x7 / (1, 2, 2) to 64, Fast 5x7x7 / (1, 2,
2) to 8, each BN, ReLU and a 1x3x3 / (1, 2, 2) max pool (pads 0, 1, 1).
A fusion after the stem and after res2, res3 and res4 takes Fast (C
channels) through a 7x1x1 / (4, 1, 1) conv to 2C, BN and ReLU, and
concatenates it after Slow's channels.  res2-res5: (3, 4, 6, 3) bottlenecks
on each pathway (the I3D-ResNet's inflated bottleneck, no non-local block):
temporal kernels 1, 1, 3, 3 (Slow) and 3 (Fast), inner widths 64-512 and
8-64, outputs 256-2048 and 32-256, stride 2 in H and W at the first block of
res3-res5.  A graph block at point p runs on Fast's input of stage p,
before that stage's fusion.  Features: each pathway's mean over T, H and
W, Slow's first.  BN: eps 1e-5, flax momentum 0.9; scales drawn as 1.

A training forward that records a graph on a CUDA device (``recompute``
None), or wherever ``recompute`` is True, runs each unit (both stems with
their pools, each fusion, each graph block, each residual block) through
``torch.utils.checkpoint``, so that the backward recomputes it instead of
keeping what is inside it: at the cell's size the plain graph does not fit
one card.  The recompute restores every BN's running statistics of its unit
afterwards, so they, and the batch variances the check reads from them,
are the first forward's.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .graph import TemporalGraphAug, stage_seed
from .i3dnl import InflatedBottleneck, bn
from .nn import MaxPool3d, Rounding, conv3d

FEATURE_DIM = 2304
LAYERS = (3, 4, 6, 3)
SLOW_PLANES = (64, 128, 256, 512)
SLOW_TK, FAST_TK = (1, 1, 3, 3), (3, 3, 3, 3)
ALPHA, BETA_INV = 4, 8


def slow_frames(t: int) -> list:
    return torch.linspace(0, t - 1, t // ALPHA).long().tolist()


@contextlib.contextmanager
def keep_running_stats(modules):
    """Restore the running statistics of ``modules``' BNs on exit."""
    saved = [(b, b.detach().clone()) for m in modules for n, b in m.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


class Fuse(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv3d(c, 2 * c, (7, 1, 1), (ALPHA, 1, 1), (3, 0, 0), bias=False)
        self.bn = bn(2 * c)
        self.rounding = Rounding()

    def forward(self, slow: torch.Tensor, fast: torch.Tensor) -> torch.Tensor:
        return torch.cat([slow, F.relu(self.bn(conv3d(fast, self.conv, self.rounding)))], dim=1)


class SlowFast(nn.Module):
    """(B, T, H, W, 3) clips -> (B, 2304) features."""

    feature_dim = FEATURE_DIM
    recompute: Optional[bool] = None

    def __init__(self, aug_points=(2, 3, 4)):
        super().__init__()
        self.slow_conv1 = nn.Conv3d(3, 64, (1, 7, 7), (1, 2, 2), (0, 3, 3), bias=False)
        self.slow_bn1 = bn(64)
        self.fast_conv1 = nn.Conv3d(3, 8, (5, 7, 7), (1, 2, 2), (2, 3, 3), bias=False)
        self.fast_bn1 = bn(8)
        self.pool = MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.rounding = Rounding()
        self.aug_points = tuple(aug_points)
        slow_in, fast_in = 64, 8
        for stage, (planes, n) in enumerate(zip(SLOW_PLANES, LAYERS), start=1):
            setattr(self, f"fuse{stage - 1}", Fuse(fast_in))
            slow_in += 2 * fast_in
            for path, cin, p, tk in (("slow", slow_in, planes, SLOW_TK[stage - 1]),
                                     ("fast", fast_in, planes // BETA_INV, FAST_TK[stage - 1])):
                layer = nn.Sequential(*(InflatedBottleneck(cin if b == 0 else p * 4, p, tk,
                                                           2 if (b == 0 and stage > 1) else 1,
                                                           False) for b in range(n)))
                if path == "fast" and stage in self.aug_points:
                    layer = nn.Sequential(TemporalGraphAug(cin), layer)
                setattr(self, f"{path}_layer{stage}", layer)
            slow_in, fast_in = planes * 4, planes // BETA_INV * 4

    def _unit(self, fn, modules, *xs):
        on = self.recompute if self.recompute is not None else xs[0].device.type == "cuda"
        if not (on and self.training and torch.is_grad_enabled()):
            return fn(*xs)
        return checkpoint(fn, *xs, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              keep_running_stats(modules)))

    def _stems(self, x: torch.Tensor):
        x = x.permute(0, 4, 1, 2, 3)
        idx = torch.tensor(slow_frames(x.shape[2]), device=x.device)
        r = self.rounding
        slow = F.relu(self.slow_bn1(conv3d(x.index_select(2, idx), self.slow_conv1, r)))
        fast = F.relu(self.fast_bn1(conv3d(x, self.fast_conv1, r)))
        return self.pool(slow), self.pool(fast)

    def forward(self, x: torch.Tensor, graph_seed: int) -> torch.Tensor:
        slow, fast = self._unit(self._stems, (self.slow_bn1, self.fast_bn1), x)
        for stage in range(1, 5):
            slow_layer = getattr(self, f"slow_layer{stage}")
            fast_layer = getattr(self, f"fast_layer{stage}")
            if stage in self.aug_points:
                graph, fast_layer = fast_layer[0], fast_layer[1]
                seed = stage_seed(graph_seed, stage)
                fast = self._unit(lambda f, g=graph, s=seed: g(f.permute(0, 2, 3, 4, 1), s)
                                  .permute(0, 4, 1, 2, 3), (graph,), fast)
            fuse = getattr(self, f"fuse{stage - 1}")
            slow = self._unit(fuse, (fuse,), slow, fast)
            for block in slow_layer:
                slow = self._unit(block, (block,), slow)
            for block in fast_layer:
                fast = self._unit(block, (block,), fast)
        return torch.cat([slow.mean(dim=(2, 3, 4)), fast.mean(dim=(2, 3, 4))], dim=1)
