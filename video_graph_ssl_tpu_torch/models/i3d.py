"""I3D backbone (counterpart of ``video_graph_ssl_tpu/models/i3d.py``): the
inflated Inception-v1 of the reference's ``I3D`` and ``InceptionI3d``
(i3dpt.py:161-311, i3d_inception.py:152-338, one network under two
names), with TF "SAME" padding everywhere.

Full 3D convolutions (``Unit3D``: conv, no bias, + BN eps 1e-3, flax
momentum 0.999, + ReLU), the Mixed specs of S3D, feature dim 1024.  The
stages follow S3D's index plan (``base.N``; JAX ``i3d.py:176-187``), so
graph blocks sit on the inputs of stages 5, 9 and 14 and ``head_pool`` is
S3D's:

| idx | stage                           | TF "SAME" pads (16x112x112, bs 128) |
|-----|---------------------------------|-------------------------------------|
| 0   | Unit3D 7x7x7 / 2 (conv3d_1a)    | (2, 3) on T, H, W                    |
| 1   | MaxPool (1,3,3)/(1,2,2)         | H, W (0, 1): 56 -> 28                |
| 2   | Unit3D 1x1x1 (conv3d_2b)        | none                                 |
| 3   | Unit3D 3x3x3 (conv3d_2c)        | (1, 1)                               |
| 4   | MaxPool (1,3,3)/(1,2,2)         | H, W (0, 1): 28 -> 14                |
| 5,6 | Mixed_3b, 3c                    | branch pools (1, 1)                  |
| 7   | MaxPool 3/2                     | (0, 1) on T, H, W: 8x14x14 -> 4x7x7  |
| 8-12| Mixed_4b..4f                    |                                      |
| 13  | MaxPool 2/2                     | T none, H, W (0, 1): 4x7x7 -> 2x4x4  |
| 14,15 | Mixed_5b, 5c                  |                                      |

Stage 13's output is 4x4 where S3D's ``MaxPool3d(2, 2, 0)`` gives 3x3, so
the graph block at 14 sees (B, 2, 4, 4, 832).  Every strided pool pads one
more on its high side than on its low side; ``ops/maxpool.py`` takes that
padding, forward and backward (K4).  The stem conv's (2, 3) padding is a
zero-pad copy of the 3-channel clip (``layers.conv3d_same``); the 3x3x3/1
and 1x1x1 convs pad symmetrically, in the convolution.

The JAX ``TPU.PACK_POINTWISE`` packing is the same math on the same
parameters, so the three 1x1x1 convs of a Mixed block stay separate.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import BasicConv3d, InceptionBlock, MaxPool3d, conv3d_same
from .s3d import _MIXED_SPECS, S3D_FEATURE_DIM, StagedBackbone, mixed_stages

I3D_FEATURE_DIM = S3D_FEATURE_DIM


class Unit3D(BasicConv3d):
    """conv (TF "SAME", no bias) + BN + ReLU (JAX ``Unit3D``; reference
    Unit3Dpy, i3dpt.py:38-107)."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, cout, kernel_size, stride, 0, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        y = conv3d_same(x.to(self.dtype), c.weight.to(self.dtype), None, c.stride)
        return F.relu(self.bn(y).to(self.dtype))


def I3DMixed(cin: int, b0, b1, b2, b3, dtype: torch.dtype = torch.bfloat16) -> InceptionBlock:
    """Inception block of Unit3Ds with full 3x3x3 branch convs (JAX
    ``I3DMixed``; reference Mixed, i3dpt.py:124-158)."""
    return InceptionBlock(cin, b0, b1, b2, b3, dtype=dtype, unit=Unit3D)


class I3D(StagedBackbone):
    """I3D encoder: (B, T, H, W, 3) clips -> (B, 1024) fp32 features.
    ``partial_bn`` freezes every BN after ``conv3d_1a`` (JAX ``i3d.py:168-170``);
    the graph blocks' BNs stay live."""

    def __init__(self, aug_points: Tuple[int, ...] = (),
                 graph_cfg: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.bfloat16, partial_bn: bool = False):
        super().__init__()
        kw = dict(dtype=dtype)
        stem = [
            Unit3D(3, 64, 7, 2, **kw),
            MaxPool3d((1, 3, 3), (1, 2, 2), "SAME"),
            Unit3D(64, 64, 1, **kw),
            Unit3D(64, 192, 3, **kw),
            MaxPool3d((1, 3, 3), (1, 2, 2), "SAME"),
        ]
        stages, cins = mixed_stages(
            stem, lambda idx, cin: I3DMixed(cin, *_MIXED_SPECS[idx], **kw),
            MaxPool3d(3, 2, "SAME"), MaxPool3d(2, 2, "SAME"))
        self._finish(stages, cins, aug_points, graph_cfg, dtype, partial_bn)
