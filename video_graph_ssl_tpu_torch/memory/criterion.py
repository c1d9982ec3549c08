"""Contrastive criteria (counterpart of ``video_graph_ssl_tpu/memory/criterion.py``):
InfoNCE (cross-entropy against column 0), the true NCE loss with uniform
noise ``P_n = 1 / n_data``, and SimSiam's negative cosine ``simsiam_d``
(re-exported from ``models.wrappers``)."""

from __future__ import annotations

import torch

from ..models.wrappers import simsiam_d  # noqa: F401  (re-export)

EPS = 1e-7


def nce_softmax_loss(logits: torch.Tensor) -> torch.Tensor:
    """InfoNCE: cross-entropy with the positive at column 0."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp[:, 0].mean()


def nce_criterion(x: torch.Tensor, n_data: int) -> torch.Tensor:
    """True NCE loss with uniform noise ``P_n = 1 / n_data`` on (B, K+1)
    scores with the positive in column 0.

    As in JAX (and the reference), the bank step feeds it the raw ``dot/T``
    scores, so ``p + m * P_n`` can be negative and the loss non-finite:
    kept as it is."""
    x = x.float()
    bsz, m = x.shape[0], x.shape[1] - 1
    pn = 1.0 / float(n_data)
    p_pos = x[:, 0]
    log_d1 = torch.log(p_pos / (p_pos + m * pn + EPS))
    p_neg = x[:, 1:]
    log_d0 = torch.log((m * pn) / (p_neg + m * pn + EPS))
    return -(log_d1.sum() + log_d0.sum()) / bsz
