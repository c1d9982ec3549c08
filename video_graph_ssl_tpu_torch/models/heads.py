"""Contrastive projection head (counterpart of
``video_graph_ssl_tpu/models/heads.py``); runs in fp32."""

from __future__ import annotations

import torch
from torch import nn


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize(p=2)``: x / max(||x||, eps)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / norm.clamp_min(eps)


class ProjectHead(nn.Module):
    """Linear or 2-layer MLP + L2 normalise; reference names
    ``head.0`` / ``head.2``."""

    def __init__(self, in_dim: int, feat_dim: int = 128, head_type: str = "mlp"):
        super().__init__()
        if head_type == "linear":
            self.head = nn.Sequential(nn.Linear(in_dim, feat_dim))
        elif head_type == "mlp":
            self.head = nn.Sequential(nn.Linear(in_dim, in_dim), nn.ReLU(),
                                      nn.Linear(in_dim, feat_dim))
        else:
            raise NotImplementedError(f"head not supported: {head_type}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.head(x.float()), dim=-1)
