"""Temporal aggregation over the frame axis (counterpart of
``video_graph_ssl_tpu/ops/pooling.py``): the avg or max consensus of the
reference's ``TemporalAggreModel`` over per-frame features of a 2D
backbone."""

from __future__ import annotations

import torch


def temporal_aggregate(x: torch.Tensor, mode: str = "avg", axis: int = 1) -> torch.Tensor:
    """Aggregate (B, T, D) frame features (or any ``axis``) to clip features."""
    if mode == "avg":
        return x.mean(dim=axis)
    if mode == "max":
        return x.amax(dim=axis)
    raise ValueError(f"Unknown aggregation mode: {mode} (supported: avg, max)")
