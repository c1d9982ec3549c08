"""Projection and prediction heads (counterpart of
``video_graph_ssl_tpu/models/heads.py``); they run in fp32.

``ProjectHead`` is the MoCo/bank head; ``ProjectionMLP`` and
``PredictionMLP`` are SimSiam's, whose BN layers are flax's defaults
(momentum 0.9, eps 1e-5, biased running variance) through the port's
:class:`~video_graph_ssl_tpu_torch.models.layers.BatchNorm`, so that under
ranks they span the global batch like the backbone's.  Names are the
reference's: ``l{1,2,3}.0`` the Linear and ``l{1,2,3}.1`` the BN of a
layer, ``prediction.l2`` the last Linear.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm

# flax nn.BatchNorm's defaults, which the JAX heads keep
HEAD_BN_MOMENTUM, HEAD_BN_EPS = 0.9, 1e-5


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize(p=2)``: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / norm.clamp_min(eps)


def jax_fc(linear: nn.Linear) -> nn.Linear:
    """Marks a layer the JAX package names ``fc``: the TSN trick groups it
    with the classifier (``solver/build.py:label_params_trick``)."""
    linear.jax_fc = True
    return linear


class ProjectHead(nn.Module):
    """Linear or 2-layer MLP + L2 normalise; reference names
    ``head.0`` / ``head.2``."""

    def __init__(self, in_dim: int, feat_dim: int = 128, head_type: str = "mlp"):
        super().__init__()
        if head_type == "linear":
            self.head = nn.Sequential(jax_fc(nn.Linear(in_dim, feat_dim)))
        elif head_type == "mlp":
            self.head = nn.Sequential(nn.Linear(in_dim, in_dim), nn.ReLU(),
                                      nn.Linear(in_dim, feat_dim))
        else:
            raise NotImplementedError(f"head not supported: {head_type}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.head(x.float()), dim=-1)


class _DenseBNReLU(nn.Sequential):
    """Linear (``0``) + BN (``1``, fp32) + optional ReLU on (B, C)."""

    def __init__(self, in_dim: int, out_dim: int, relu: bool = True):
        super().__init__(jax_fc(nn.Linear(in_dim, out_dim)),
                         BatchNorm(out_dim, HEAD_BN_MOMENTUM, HEAD_BN_EPS,
                                   dtype=torch.float32))
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2:
            raise ValueError(f"a head layer takes (B, C), got {tuple(x.shape)}")
        x = self[1](self[0](x))
        return F.relu(x) if self.relu else x


class ProjectionMLP(nn.Module):
    """SimSiam's 3-layer projection: BN after every layer, no ReLU on the
    output."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int):
        super().__init__()
        self.l1 = _DenseBNReLU(in_dim, hid_dim)
        self.l2 = _DenseBNReLU(hid_dim, hid_dim)
        self.l3 = _DenseBNReLU(hid_dim, out_dim, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.l3(self.l2(self.l1(x.float())))


class PredictionMLP(nn.Module):
    """SimSiam's 2-layer prediction: Linear + BN + ReLU, then Linear."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int):
        super().__init__()
        self.l1 = _DenseBNReLU(in_dim, hid_dim)
        self.l2 = nn.Linear(hid_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.l2(self.l1(x.float()))
