"""Pretraining state (counterpart of ``video_graph_ssl_tpu/engine/train_state.py``).

The JAX package keeps params, BN stats, optimizer buffers, the EMA encoder
and the queue in one functional pytree.  Here they are the query model,
its EMA copy, the optimizer and the MoCo queue, updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..memory.moco import MocoState


@dataclass
class PretrainState:
    model: nn.Module                 # query encoder (+ head), trained
    ema_model: nn.Module             # MoCo momentum encoder, no grads
    optimizer: torch.optim.Optimizer
    contrast: MocoState
    seed: int                        # base of the per-step graph/augment seeds
    step: int = 0

    def step_seed(self, stream: int) -> int:
        """Per-step seed of one random stream (1: graph noise, 2: augment),
        the same for every pass of a step."""
        return ((self.seed * 1_000_003 + self.step) * 31 + stream) \
            & 0x7FFF_FFFF_FFFF_FFFF


@torch.no_grad()
def ema_update(model: nn.Module, ema_model: nn.Module, alpha: float) -> None:
    """ema = alpha * ema + (1 - alpha) * params, over parameters only (the
    EMA BN statistics come from the key pass)."""
    for e, p in zip(ema_model.parameters(), model.parameters()):
        e.mul_(alpha).add_(p.detach().to(e.dtype), alpha=1.0 - alpha)
