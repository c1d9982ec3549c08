"""Model wrappers (counterpart of ``video_graph_ssl_tpu/models/wrappers.py``):
encoder -> projection head, under the reference's ``GraphWrapper`` names
(``model.encoder.base_model.*``, ``model.proj_head.head.*``).

Clips arrive as ``(B, T, H, W, C)``; ``graph_seed`` keys the graph-block
noise of one pass.
"""

from __future__ import annotations

import torch
from torch import nn

from .heads import ProjectHead


class VisualEncoder(nn.Module):
    """3D backbone + feature dropout -> (B, feat_dim)."""

    def __init__(self, backbone: nn.Module, dropout: float = 0.0):
        super().__init__()
        self.base_model = backbone
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None

    def forward(self, x: torch.Tensor, graph_seed: int = 0) -> torch.Tensor:
        feat = self.base_model(x, graph_seed=graph_seed)
        if self.dropout is not None:
            feat = self.dropout(feat)
        return feat


class ContrastWrapper(nn.Module):
    """encoder -> ProjectHead (L2-normalised features)."""

    def __init__(self, encoder: VisualEncoder, feat_dim: int, hid_dim: int = 128,
                 head_type: str = "mlp"):
        super().__init__()
        self.encoder = encoder
        self.proj_head = ProjectHead(feat_dim, hid_dim, head_type)

    def forward(self, x: torch.Tensor, graph_seed: int = 0) -> torch.Tensor:
        return self.proj_head(self.encoder(x, graph_seed=graph_seed))


class GraphWrapper(nn.Module):
    """The MoCo/bank model: ``model`` is a ContrastWrapper."""

    def __init__(self, model: ContrastWrapper):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor, graph_seed: int = 0) -> torch.Tensor:
        return self.model(x, graph_seed=graph_seed)

    def encode(self, x: torch.Tensor, graph_seed: int = 0) -> torch.Tensor:
        return self.model.encoder(x, graph_seed=graph_seed)
