"""S3D backbone (counterpart of ``video_graph_ssl_tpu/models/s3d.py``).

``base`` is the reference's 16-stage Sequential; a stage at a graph-aug
point becomes ``Sequential(TemporalGraphAug, stage)`` (names ``base.{i}.0``
and ``base.{i}.1``), the augmentation running on the stage's input.

| idx | stage                   | out ch |
|-----|-------------------------|--------|
| 0   | SepConv3d k7 s2 p3      | 64     |
| 1   | MaxPool (1,3,3)/(1,2,2) | 64     |
| 2   | BasicConv3d k1          | 64     |
| 3   | SepConv3d k3 p1         | 192    |
| 4   | MaxPool (1,3,3)/(1,2,2) | 192    |
| 5,6 | Mixed_3b, 3c            | 256, 480 |
| 7   | MaxPool 3/2             | 480    |
| 8-12| Mixed_4b..4f            | 512, 512, 512, 528, 832 |
| 13  | MaxPool 2/2             | 832    |
| 14,15 | Mixed_5b, 5c          | 832, 1024 |
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.temporal_graph import TemporalGraphAug, stage_seed
from . import remat
from .layers import BasicConv3d, InceptionBlock, MaxPool3d, SepConv3d, freeze_bn_

_MIXED_SPECS = {
    5: (64, (96, 128), (16, 32), 32),
    6: (128, (128, 192), (32, 96), 64),
    8: (192, (96, 208), (16, 48), 64),
    9: (160, (112, 224), (24, 64), 64),
    10: (128, (128, 256), (24, 64), 64),
    11: (112, (144, 288), (32, 64), 64),
    12: (256, (160, 320), (32, 128), 128),
    14: (256, (160, 320), (32, 128), 128),
    15: (384, (192, 384), (48, 128), 128),
}

S3D_FEATURE_DIM = 1024


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, C, T, H, W) view in channels_last_3d memory."""
    return x.permute(0, 4, 1, 2, 3)


def to_bthwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, T, H, W, C); free for channels_last_3d."""
    return x.permute(0, 2, 3, 4, 1)


def run_stages(base: nn.Sequential, x: torch.Tensor, aug_points,
               seed: int, rows: Optional[Tuple[int, int]] = None,
               policy: remat.Policy = False) -> torch.Tensor:
    """Run a backbone's stage Sequential on an NCDHW tensor; aug-wrapped
    stages run their graph block on the (B, T, H, W, C) view first, with
    ``rows`` (row0, global B) placing the batch in a global one for the
    graph noise.  Under a remat ``policy`` every stage but the pools is a
    recompute unit (``models/remat.py``); a graph block stays outside its
    stage's unit."""
    for idx, stage in enumerate(base):
        if idx in aug_points:
            graph, stage = stage[0], stage[1]
            x = to_ncdhw(graph(to_bthwc(x), seed=stage_seed(seed, idx), rows=rows))
        x = stage(x) if isinstance(stage, MaxPool3d) else remat.run(stage, x, policy)
    return x


def head_pool(x: torch.Tensor) -> torch.Tensor:
    """Reference head pooling: spatial mean, average of adjacent-frame
    pairs, temporal mean -- endpoint frames get half weight when T' > 2."""
    y = x.float().mean(dim=(3, 4)).transpose(1, 2)      # (B, T', C)
    if y.shape[1] > 1:
        y = (y[:, :-1] + y[:, 1:]) * 0.5
    return y.mean(dim=1)


class StagedBackbone(nn.Module):
    """A backbone run as one Sequential of stages, ``base`` (S3D, S3DG and
    I3D): the stages at ``aug_points`` are wrapped with a graph block on
    their input; ``partial_bn`` freezes every BN after stage 0 outside the
    graph blocks; ``remat`` (``TPU.REMAT``: False, True or "conv_saved")
    recomputes each stage but the pools in the backward, as the JAX S3D and
    I3D ``nn.remat`` their stem units and Mixed blocks.  Subclasses give
    the stages and each stage's input channels to :meth:`_finish`."""

    def _finish(self, stages, cins, aug_points, graph_cfg, dtype, partial_bn,
                policy: remat.Policy = False) -> None:
        self.aug_points = tuple(int(i) for i in aug_points)
        self.remat = remat.check_policy(policy)
        for idx in self.aug_points:
            graph = TemporalGraphAug(cins[idx], dtype=dtype, **(graph_cfg or {}))
            stages[idx] = nn.Sequential(graph, stages[idx])
        self.base = nn.Sequential(*stages)
        self.dtype = dtype
        if partial_bn:
            for stage in self.base[1:]:
                freeze_bn_(stage)

    @property
    def feature_dim(self) -> int:
        return S3D_FEATURE_DIM

    def forward(self, x: torch.Tensor, graph_seed: int = 0,
                graph_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        x = to_ncdhw(x).to(self.dtype)
        x = run_stages(self.base, x, self.aug_points, graph_seed, graph_rows, self.remat)
        return head_pool(x)


def mixed_stages(stem, mixed, pool_7, pool_13):
    """The 16 stages from the five of the stem: ``mixed(idx, cin)`` builds
    the Inception block at ``idx``, and the pools at 7 and 13 are given;
    returns (stages, each stage's input channels)."""
    stages, cins, cin = list(stem), [3, 64, 64, 64, 192], 192
    for idx in range(5, 16):
        cins.append(cin)
        if idx in (7, 13):
            stages.append(pool_7 if idx == 7 else pool_13)
        else:
            stages.append(mixed(idx, cin))
            cin = InceptionBlock.out_channels(*_MIXED_SPECS[idx])
    return stages, cins


class S3D(StagedBackbone):
    """S3D encoder: (B, T, H, W, 3) clips -> (B, 1024) fp32 features.

    ``fused_sepconv`` (``TPU.SEPCONV_FUSED``) gives the Mixed blocks' branch
    SepConvs the three-sweep backward (``SepConv3d.fused_bwd``); the stem
    SepConvs keep the standard path, as in the JAX S3D.

    ``partial_bn`` (downstream training unless ``MODEL.NO_PARTIALBN``)
    freezes every BN after ``stem_0`` (``layers.freeze_bn_``): stage
    granular as in the JAX S3D, so ``stem_0``'s two BNs stay live; the graph
    blocks' BNs stay live too.

    ``temporal_bias`` is S3DG (JAX ``S3D(temporal_bias=True)``, reference
    S3DG_Pytorch.py:310-355): every SepConv pair, the stem's included,
    biased; ``fused_sepconv`` then reaches no pair (``SepConv3d``)."""

    def __init__(self, aug_points: Tuple[int, ...] = (),
                 graph_cfg: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 fused_sepconv: bool = False, partial_bn: bool = False,
                 temporal_bias: bool = False, in_channels: int = 3,
                 remat: remat.Policy = False):
        super().__init__()
        kw = dict(dtype=dtype)
        skw = dict(temporal_bias=temporal_bias, **kw)
        stem = [
            SepConv3d(in_channels, 64, 7, 2, 3, **skw),
            MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)),
            BasicConv3d(64, 64, 1, **kw),
            SepConv3d(64, 192, 3, 1, 1, **skw),
            MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)),
        ]
        stages, cins = mixed_stages(
            stem, lambda idx, cin: InceptionBlock(cin, *_MIXED_SPECS[idx],
                                                  fused_sepconv=fused_sepconv, **skw),
            MaxPool3d(3, 2, 1), MaxPool3d(2, 2, 0))
        self._finish(stages, cins, aug_points, graph_cfg, dtype, partial_bn, remat)
