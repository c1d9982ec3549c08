"""SlowFast-R50, 8x8 (``slowfast_r50``): Feichtenhofer, Fan, Malik and He,
*SlowFast Networks for Video Recognition*, ICCV 2019 (arXiv 1812.03982), at
PySlowFast's ``configs/Kinetics/SLOWFAST_8x8_R50.yaml``.  The JAX package
has no counterpart: this backbone is the port's own.

A (B, 32, H, W, 3) clip feeds two pathways.  Slow takes T / alpha = 8
frames, ``linspace(0, T - 1, T / alpha)`` truncated (PySlowFast's
``pack_pathway_output``: frames 0, 4, 8, 13, 17, 22, 26, 31 of 32), at full
width; Fast takes all T at beta = 1/8 of the width.

* Stems: Slow conv 1x7x7 / (1, 2, 2), pads (0, 3, 3), to 64 channels; Fast
  conv 5x7x7 / (1, 2, 2), pads (2, 3, 3), to 8; each with BN and ReLU (both
  under one ``stem`` span), then a 1x3x3 / (1, 2, 2) max pool, pads (0, 1,
  1), through ``layers.max_pool_3d`` (the forward kernel and K4 on CUDA
  tensors).
* Lateral fusions (``fuse0`` .. ``fuse3``) after the stem, res2, res3 and
  res4: Fast (C_f channels) through conv 7x1x1 / (4, 1, 1), pads (3, 0, 0),
  to 2 C_f channels (no bias), BN, ReLU, concatenated after Slow's
  channels; each under a ``fuse`` span.
* res2-res5 (``slow_layer1..4``, ``fast_layer1..4``), (3, 4, 6, 3)
  bottlenecks on both pathways (``i3dnon.InflatedBottleneck`` without its
  non-local block: conv1 (k, 1, 1), pads (k // 2, 0, 0); conv2 1x3x3 / (1,
  s, s), pads (0, 1, 1); conv3 1x1x1; BN after each, ReLU after the first
  two; the 1x1x1 / (1, s, s) conv + BN shortcut where the shape changes;
  ReLU after the add).  s is 1 in res2 and 2 after; T is never strided.  k
  is 1, 1, 3, 3 on Slow and 3 everywhere on Fast.  Inner widths 64-512
  (Slow) and 8-64 (Fast), outputs 256-2048 and 32-256; Slow's inputs after
  the fusions 80, 320, 640, 1280.  No pool between stages.
* Features: each pathway's mean over T, H and W, concatenated (Slow
  first): (B, 2304) in fp32.

Graph blocks (GCA's ``TemporalGraphAug``, K1 and K2 on CUDA tensors) run on
the Fast pathway, the one that keeps every frame, at ``aug_points`` (of
1-4; the registry's default is 2, 3, 4, the inputs of res3, res4 and res5):
at point p, ``fast_layerP`` is ``Sequential(graph, stage)`` as in
``resnet3d.py``, and the order is the graph block on Fast, then the fusion
``fuse{p-1}``, which reads the augmented Fast tensor, then both stages.  At
32 frames every block sees T = 32.  ``graph_seed`` and ``graph_rows`` reach
the blocks as in ``ResNetStages``.

Departures from PySlowFast: BN is flax's (momentum 0.9 = PySlowFast's 0.1,
eps 1e-5) and its scales start at 1 (``ZERO_INIT_FINAL_BN`` is not
applied); the head's dropout and classifier are left out (the pretraining
model's projection head takes the features); module names follow the
port's ResNets, not PySlowFast's ``s1.pathway0_stem`` names; the graph
blocks are GCA's addition.  ``remat`` (``TPU.REMAT`` block) recomputes each
residual block of both pathways in the backward (``models/remat.py``).

Not taken, each raising a ``ValueError`` that names it: ``TPU.STEM_S2D``
and ``TPU.SEPCONV_FUSED`` (S3D's, refused by ``build.create_backbone``),
``TPU.REMAT_POLICY conv_saved`` (likewise), and partial BN (the downstream
fine-tune's ``partial_bn``, refused here).  The export and Grad-CAM do not
handle this backbone.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.temporal_graph import TemporalGraphAug, stage_seed
from ..utils import tracing
from . import remat
from .i3dnon import InflatedBottleneck
from .layers import conv, max_pool_3d
from .resnet2d import _bn
from .s3d import to_bthwc, to_ncdhw

SLOWFAST_FEATURE_DIM = 2304
ALPHA = 4                       # frame-rate ratio of Fast to Slow
BETA_INV = 8                    # channel ratio of Slow to Fast
FUSION_RATIO = 2                # a fusion's output channels over Fast's
FUSION_KERNEL = 7
LAYERS = (3, 4, 6, 3)
SLOW_TIME_KERNELS = (1, 1, 3, 3)
FAST_TIME_KERNELS = (3, 3, 3, 3)
SLOW_PLANES = (64, 128, 256, 512)


@functools.lru_cache(maxsize=8)
def slow_frames(t: int) -> Tuple[int, ...]:
    """The Slow pathway's frames of a T-frame clip: PySlowFast's
    ``torch.linspace(0, T - 1, T // alpha).long()``."""
    return tuple(int(i) for i in torch.linspace(0, t - 1, t // ALPHA).long())


class FuseFastToSlow(nn.Module):
    """Fast (C_f) -> conv 7x1x1 / (alpha, 1, 1) to 2 C_f, BN, ReLU,
    concatenated after Slow's channels (PySlowFast ``FuseFastToSlow``)."""

    def __init__(self, fast_channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv = nn.Conv3d(fast_channels, fast_channels * FUSION_RATIO,
                              (FUSION_KERNEL, 1, 1), (ALPHA, 1, 1), (FUSION_KERNEL // 2, 0, 0),
                              bias=False)
        self.bn = _bn(fast_channels * FUSION_RATIO)
        self.dtype = dtype

    def forward(self, slow: torch.Tensor, fast: torch.Tensor) -> torch.Tensor:
        with tracing.span("fuse"):
            f = F.relu(self.bn(conv(fast, self.conv, self.dtype)).to(self.dtype))
            return torch.cat([slow, f], dim=1)


class SlowFast(nn.Module):
    """(B, T, H, W, in_channels) clips -> (B, 2304) fp32 features."""

    def __init__(self, layers: Sequence[int] = LAYERS, aug_points: Tuple[int, ...] = (),
                 graph_cfg: Optional[Dict[str, Any]] = None, partial_bn: bool = False,
                 dtype: torch.dtype = torch.bfloat16, in_channels: int = 3,
                 remat: remat.Policy = False):
        super().__init__()
        if partial_bn:
            raise ValueError("partial_bn (the fine-tune's default, MODEL.NO_PARTIALBN False) "
                             "does not apply to slowfast_r50")
        self.dtype, self.remat = dtype, remat
        self.aug_points = tuple(int(i) for i in aug_points)
        slow_stem = SLOW_PLANES[0]
        fast_stem = slow_stem // BETA_INV
        self.slow_conv1 = nn.Conv3d(in_channels, slow_stem, (1, 7, 7), (1, 2, 2), (0, 3, 3),
                                    bias=False)
        self.slow_bn1 = _bn(slow_stem)
        self.fast_conv1 = nn.Conv3d(in_channels, fast_stem, (5, 7, 7), (1, 2, 2), (2, 3, 3),
                                    bias=False)
        self.fast_bn1 = _bn(fast_stem)
        slow_in, fast_in = slow_stem, fast_stem
        for stage, (planes, n) in enumerate(zip(SLOW_PLANES, layers), start=1):
            self.add_module(f"fuse{stage - 1}", FuseFastToSlow(fast_in, dtype))
            slow_in += fast_in * FUSION_RATIO
            fast_planes = planes // BETA_INV
            for path, cin, p, tk in (("slow", slow_in, planes, SLOW_TIME_KERNELS[stage - 1]),
                                     ("fast", fast_in, fast_planes,
                                      FAST_TIME_KERNELS[stage - 1])):
                layer = nn.Sequential(*(
                    InflatedBottleneck(cin if b == 0 else p * 4, p, tk,
                                       2 if (b == 0 and stage > 1) else 1, False, dtype)
                    for b in range(n)))
                if path == "fast" and stage in self.aug_points:
                    layer = nn.Sequential(TemporalGraphAug(cin, dtype=dtype, **(graph_cfg or {})),
                                          layer)
                setattr(self, f"{path}_layer{stage}", layer)
            slow_in, fast_in = planes * 4, fast_planes * 4
        self.feature_dim = slow_in + fast_in
        self._frames = {}

    def _slow_index(self, t: int, device: torch.device) -> torch.Tensor:
        key = (t, str(device))
        if key not in self._frames:
            self._frames[key] = torch.tensor(slow_frames(t), device=device)
        return self._frames[key]

    def _stem(self, x: torch.Tensor, c: nn.Conv3d, bn: nn.Module,
              frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        return F.relu(bn(conv(to_ncdhw(x), c, self.dtype, frames)).to(self.dtype))

    def forward(self, x: torch.Tensor, graph_seed: int = 0,
                graph_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if x.shape[1] % ALPHA:
            raise ValueError(f"slowfast_r50 takes a multiple of {ALPHA} frames, got {x.shape[1]}")
        with tracing.span("stem"):
            slow = self._stem(x, self.slow_conv1, self.slow_bn1,
                              self._slow_index(x.shape[1], x.device))
            fast = self._stem(x, self.fast_conv1, self.fast_bn1)
        slow = max_pool_3d(slow, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        fast = max_pool_3d(fast, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for stage in range(1, 5):
            slow_layer = getattr(self, f"slow_layer{stage}")
            fast_layer = getattr(self, f"fast_layer{stage}")
            if stage in self.aug_points:
                graph, fast_layer = fast_layer[0], fast_layer[1]
                fast = to_ncdhw(graph(to_bthwc(fast), seed=stage_seed(graph_seed, stage),
                                      rows=graph_rows))
            slow = getattr(self, f"fuse{stage - 1}")(slow, fast)
            for block in slow_layer:
                slow = remat.run(block, slow, self.remat)
            for block in fast_layer:
                fast = remat.run(block, fast, self.remat)
        return torch.cat([slow.float().mean(dim=(2, 3, 4)), fast.float().mean(dim=(2, 3, 4))],
                         dim=1)


def slowfast_r50(**kw) -> SlowFast:
    return SlowFast(LAYERS, **kw)
