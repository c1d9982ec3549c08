"""Model wrappers (counterpart of ``video_graph_ssl_tpu/models/wrappers.py``):
encoder -> projection head (MoCo, bank) or SimSiam's two-view model, under
the reference's ``GraphWrapper`` names (``model.encoder.base_model.*``,
``model.proj_head.head.*``; SimSiam: ``model.projection.*``,
``model.prediction.*``); the downstream classifier ``VideoModel`` under the
reference's ``VideoModelWrapper`` names (``base_model.*``, ``new_fc.*``).

Clips arrive as ``(B, T, H, W, C)``; ``graph_seed`` keys the graph-block
noise of one pass, and ``graph_rows`` (row0, global B), on a rank holding
rows ``[row0, row0 + B)`` of a global batch, makes that noise those rows of
the global batch's draw.  SimSiam takes both views ``(B, 2, T, H, W, C)``
and one seed per view: in JAX each call of a graph block draws a fresh key
(flax's per-call ``make_rng``), so its two branches get different noise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.graph_kernel import global_rows
from ..ops.pooling import temporal_aggregate
from ..ops.temporal_graph import stage_seed
from .heads import PredictionMLP, ProjectHead, ProjectionMLP, l2_normalize

Rows = Optional[Tuple[int, int]]
# the dropout's seed is the pass's graph seed keyed as one stage past the
# last backbone stage (S3D's are 0-15)
DROPOUT_STAGE = 16


def rgb_diff(x: torch.Tensor, n_channels: int = 3) -> torch.Tensor:
    """RGBDiff (JAX ``rgb_diff``): clips (..., C (new_length + 1)) of
    channel-stacked frame groups -> (..., C new_length), each group minus
    the one before it (the dataset loads the extra group)."""
    groups = x.reshape(tuple(x.shape[:-1]) + (-1, n_channels))
    d = groups[..., 1:, :] - groups[..., :-1, :]
    return d.reshape(tuple(x.shape[:-1]) + (-1,))


def keyed_dropout(x: torch.Tensor, p: float, seed: int, rows: Rows = None) -> torch.Tensor:
    """Dropout of rate ``p`` whose keep mask is drawn from ``seed`` (with
    ``rows``, those rows of the global batch's draw), so a step's mask is
    its own stream's, on any device: kept entries are scaled by 1/(1-p)."""
    full, row0 = global_rows(x.shape, rows)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed))
    u = torch.rand(full, generator=gen, device=x.device)[row0:row0 + x.shape[0]]
    return torch.where(u >= p, x / (1.0 - p), torch.zeros_like(x))


class VisualEncoder(nn.Module):
    """Backbone (+ the 2D branch's frame aggregation) + feature dropout ->
    (B, feat_dim).  A 2D backbone (``backbone_type`` 2D) sees the clips'
    B x T frames as one batch, its (B, T, D) features are aggregated over T
    under ``agg_fun`` (``MODEL.POOLING_TYPE``: avg or max), as in JAX
    ``wrappers.py:84-88``; a 3D backbone ignores ``agg_fun``.  The dropout
    runs in train mode only, keyed on the pass's ``graph_seed``.  Under
    ``modality`` RGBDiff the clips' stacked frame groups become their
    differences first (:func:`rgb_diff`, JAX ``wrappers.py:73-74``)."""

    def __init__(self, backbone: nn.Module, dropout: float = 0.0,
                 backbone_type: str = "3D", agg_fun: str = "avg", modality: str = "RGB"):
        super().__init__()
        if backbone_type not in ("2D", "3D"):
            raise ValueError(f"Backbone type must be 2D or 3D, got {backbone_type}")
        self.base_model = backbone
        self.dropout = float(dropout)
        self.backbone_type = backbone_type
        self.agg_fun = agg_fun
        self.modality = modality

    def forward(self, x: torch.Tensor, graph_seed: int = 0,
                graph_rows: Rows = None) -> torch.Tensor:
        if self.modality == "RGBDiff":
            x = rgb_diff(x)
        if self.backbone_type == "2D":
            b, t = x.shape[:2]
            feat = self.base_model(x.reshape((b * t,) + tuple(x.shape[2:])))
            feat = temporal_aggregate(feat.reshape(b, t, -1), self.agg_fun, axis=1)
        else:
            feat = self.base_model(x, graph_seed=graph_seed, graph_rows=graph_rows)
        if self.training and self.dropout > 0:
            feat = keyed_dropout(feat, self.dropout, stage_seed(graph_seed, DROPOUT_STAGE),
                                 graph_rows)
        return feat


class VideoModel(VisualEncoder):
    """The downstream classifier (JAX ``VideoModel``): the encoder, then
    ``new_fc``, an fp32 Linear initialised Normal(0, 0.001) with a zero bias
    (``models/build.py:create_video_model``).  ``forward`` gives logits,
    ``encode`` the encoder's features."""

    def __init__(self, backbone: nn.Module, feat_dim: int, num_classes: int,
                 dropout: float = 0.0, backbone_type: str = "3D", agg_fun: str = "avg",
                 modality: str = "RGB"):
        super().__init__(backbone, dropout, backbone_type, agg_fun, modality)
        self.new_fc = nn.Linear(feat_dim, num_classes)

    def encode(self, x: torch.Tensor, graph_seed: int = 0,
               graph_rows: Rows = None) -> torch.Tensor:
        return super().forward(x, graph_seed, graph_rows)

    def forward(self, x: torch.Tensor, graph_seed: int = 0,
                graph_rows: Rows = None) -> torch.Tensor:
        return self.new_fc(self.encode(x, graph_seed, graph_rows).float())


class ContrastWrapper(nn.Module):
    """encoder -> ProjectHead (L2-normalised features)."""

    def __init__(self, encoder: VisualEncoder, feat_dim: int, hid_dim: int = 128,
                 head_type: str = "mlp"):
        super().__init__()
        self.encoder = encoder
        self.proj_head = ProjectHead(feat_dim, hid_dim, head_type)

    def forward(self, x: torch.Tensor, graph_seed: int = 0,
                graph_rows: Rows = None) -> torch.Tensor:
        return self.proj_head(self.encoder(x, graph_seed=graph_seed, graph_rows=graph_rows))


def simsiam_d(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Negative cosine similarity with stop-gradient on ``z`` (the
    reference's D 'v2'), norms clamped at 1e-12."""
    z = z.detach()
    return -torch.mean(torch.sum(l2_normalize(p) * l2_normalize(z), dim=-1))


class SimSiam(nn.Module):
    """Two-view SimSiam, the symmetric loss computed inside the model:
    ``D(p1, h2) / 2 + D(p2, h1) / 2``.  The encoder and both MLPs are shared
    by the views, and each view takes its own encoder pass (per-view BN
    statistics, as in JAX)."""

    def __init__(self, encoder: VisualEncoder, feat_dim: int, hid_dim: int = 1024):
        super().__init__()
        self.encoder = encoder
        self.projection = ProjectionMLP(feat_dim, hid_dim, hid_dim)
        self.prediction = PredictionMLP(hid_dim, hid_dim // 2, hid_dim)

    def branch(self, x: torch.Tensor, graph_seed: int, graph_rows: Rows = None):
        """(h, p) of one view."""
        h = self.projection(self.encoder(x, graph_seed=graph_seed, graph_rows=graph_rows))
        return h, self.prediction(h)

    def forward(self, x: torch.Tensor, graph_seed: Sequence[int] = (0, 1),
                graph_rows: Rows = None) -> torch.Tensor:
        """``x`` (B, 2, T, H, W, C), ``graph_seed`` (view 1's, view 2's) ->
        the scalar loss."""
        s1, s2 = graph_seed
        h1, p1 = self.branch(x[:, 0], s1, graph_rows)
        h2, p2 = self.branch(x[:, 1], s2, graph_rows)
        return simsiam_d(p1, h2) / 2 + simsiam_d(p2, h1) / 2


class GraphWrapper(nn.Module):
    """The pretrain model: ``model`` is a ContrastWrapper (MoCo, bank) or a
    SimSiam."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor, graph_seed=0, graph_rows: Rows = None) -> torch.Tensor:
        return self.model(x, graph_seed=graph_seed, graph_rows=graph_rows)

    def encode(self, x: torch.Tensor, graph_seed: int = 0,
               graph_rows: Rows = None) -> torch.Tensor:
        return self.model.encoder(x, graph_seed=graph_seed, graph_rows=graph_rows)
