"""Contrastive loss (counterpart of ``video_graph_ssl_tpu/memory/criterion.py``)."""

from __future__ import annotations

import torch


def nce_softmax_loss(logits: torch.Tensor) -> torch.Tensor:
    """InfoNCE: cross-entropy with the positive at column 0."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp[:, 0].mean()
