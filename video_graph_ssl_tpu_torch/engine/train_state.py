"""Training state (counterpart of ``video_graph_ssl_tpu/engine/train_state.py``),
for pretraining and for downstream training (``create_downstream_state``:
a ``VideoModel`` with no EMA encoder and no memory).

The JAX package keeps params, BN stats, optimizer buffers, the EMA encoder
and the contrast memory in one functional pytree.  Here they are the query
model, its EMA copy (MoCo only), the optimizer and the memory (the MoCo
queue or the bank; SimSiam has none), updated in place.  Under a
process group every rank holds the same state; ``ddp`` is then the query
model inside ``DistributedDataParallel``, which the step's query pass
runs through so that the gradients are averaged over ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn

from ..memory.bank import BankState, CmcBankState
from ..memory.moco import CmcMocoState, MocoState


@dataclass
class PretrainState:
    model: nn.Module                 # query encoder (+ heads), trained
    ema_model: Optional[nn.Module]   # MoCo momentum encoder, no grads; else None
    optimizer: torch.optim.Optimizer
    contrast: Optional[Union[MocoState, BankState, CmcMocoState, CmcBankState]]  # SimSiam: None
    seed: int                        # base of the per-step graph/augment seeds
    step: int = 0
    ddp: Optional[nn.Module] = None  # the query model in DistributedDataParallel

    @property
    def query(self) -> nn.Module:
        """The module the query pass runs: ``ddp`` under a process group."""
        return self.ddp if self.ddp is not None else self.model

    def step_seed(self, stream: int) -> int:
        """Per-step seed of one random stream (1: graph noise and the
        features' dropout, 2: the SSL augmentation, 3: ShuffleBN's
        permutation, 4: the bank's negative draw, 5: graph noise of
        SimSiam's second view, 6: graph noise and dropout of CMC's second
        stack, 13: the downstream ``train`` augmentation),
        the same for every pass of a step and on every rank."""
        return ((self.seed * 1_000_003 + self.step) * 31 + stream) \
            & 0x7FFF_FFFF_FFFF_FFFF


@torch.no_grad()
def ema_update(model: nn.Module, ema_model: nn.Module, alpha: float) -> None:
    """ema = alpha * ema + (1 - alpha) * params, over parameters only (the
    EMA BN statistics come from the key pass)."""
    for e, p in zip(ema_model.parameters(), model.parameters()):
        e.mul_(alpha).add_(p.detach().to(e.dtype), alpha=1.0 - alpha)
