"""Instance-discrimination memory bank (counterpart of
``video_graph_ssl_tpu/memory/bank.py``).

The bank is an ``(n_data, dim)`` L2-normalised device tensor.  Per step:
draw ``B x (K+1)`` row indices, overwrite slot 0 with each clip's own
index (the positive), gather, take the fp32 logits ``<w, x> / T``, then
after the optimizer step EMA-update the rows of the features gathered from
every rank (``bank_update``), in place.

The step's draw is uniform (the reference's alias sampler always has
uniform weights); ``bank_logits(alias=...)`` draws from
:class:`AliasTables` instead, as JAX's optional ``alias`` argument does,
the tables built with numpy as in JAX and drawn with torch.  The gather
and the bmm
are plain PyTorch, as JAX computes them in XLA outside any Pallas kernel.

CMC's dual bank (``CmcBankState``) holds one memory per modality: one
negative draw serves both, each modality's features scored against the
other modality's rows, and both memories take the EMA update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.heads import l2_normalize

Rows = Optional[Tuple[int, int]]


@dataclass
class BankState:
    memory: torch.Tensor   # (n_data, dim) L2-normalised


def init_bank(n_data: int, dim: int, generator: Optional[torch.Generator] = None,
              device="cpu") -> BankState:
    """Random L2-normalised rows, drawn on the CPU from ``generator``."""
    m = torch.randn((n_data, dim), generator=generator, dtype=torch.float32)
    return BankState(memory=l2_normalize(m, dim=-1).to(device))


@dataclass
class AliasTables:
    """O(1) multinomial sampling by alias tables: built on the host with
    numpy (the JAX package's construction), drawn on the tables' device as
    two gathers and a Bernoulli against the acceptance probability."""

    prob: torch.Tensor    # (N,) fp32 acceptance probabilities
    alias: torch.Tensor   # (N,) int64 alias indices

    @staticmethod
    def build(probs, device="cpu") -> "AliasTables":
        probs = np.asarray(probs, dtype=np.float64)
        probs = probs / probs.sum()
        n = len(probs)
        scaled = probs * n
        prob = np.zeros(n)
        alias = np.zeros(n, dtype=np.int64)
        smaller = [i for i, p in enumerate(scaled) if p < 1.0]
        larger = [i for i, p in enumerate(scaled) if p >= 1.0]
        while smaller and larger:
            small, large = smaller.pop(), larger.pop()
            prob[small] = scaled[small]
            alias[small] = large
            scaled[large] = scaled[large] - (1.0 - scaled[small])
            (smaller if scaled[large] < 1.0 else larger).append(large)
        for rest in smaller + larger:
            prob[rest] = 1.0
        return AliasTables(prob=torch.tensor(prob, dtype=torch.float32, device=device),
                           alias=torch.tensor(alias, dtype=torch.int64, device=device))

    def draw(self, generator: torch.Generator, shape) -> torch.Tensor:
        """int64 indices of ``shape`` distributed as the tables' weights."""
        n = self.prob.shape[0]
        dev = self.prob.device
        kk = torch.randint(0, n, shape, generator=generator, device=dev)
        accept = torch.rand(shape, generator=generator, device=dev) < self.prob[kk]
        return torch.where(accept, kk, self.alias[kk])


def draw_indices(generator: torch.Generator, n_data: int, b: int, K: int,
                 rows: Rows = None, alias: Optional[AliasTables] = None) -> torch.Tensor:
    """The (b, K+1) negative indices of a rank's rows, uniform over
    ``n_data`` or drawn from ``alias``: ``rows`` (row0, global B) takes
    rows ``[row0, row0 + b)`` of the global batch's draw (the whole draw
    without ``rows``), as K1's noise does."""
    row0, full = rows if rows is not None else (0, b)
    if alias is None:
        idx = torch.randint(0, n_data, (full, K + 1), generator=generator,
                            device=generator.device)
    else:
        idx = alias.draw(generator, (full, K + 1))
    return idx[row0:row0 + b]


def bank_logits(state: BankState, x: torch.Tensor, y: torch.Tensor, K: int, T: float,
                generator: Optional[torch.Generator] = None,
                idx: Optional[torch.Tensor] = None, rows: Rows = None,
                alias: Optional[AliasTables] = None):
    """``[pos; negs] / T`` fp32 logits (b, K+1) of the anchors ``x`` (b, dim)
    with their own rows ``y`` (b,) at column 0, and label 0.  The negatives
    are ``idx`` where given (b, K+1), else drawn from ``generator``
    (``draw_indices``, uniform or from ``alias`` on the generator's
    device); slot 0 is overwritten with ``y``."""
    b = x.shape[0]
    if idx is None:
        idx = draw_indices(generator, state.memory.shape[0], b, K, rows, alias)
    idx = idx.to(device=state.memory.device, dtype=torch.int64).clone()
    idx[:, 0] = y.to(idx)
    w = state.memory.index_select(0, idx.reshape(-1)).view(b, K + 1, -1)
    logits = torch.bmm(w, x.float().unsqueeze(-1)).squeeze(-1) / T
    labels = torch.zeros(b, dtype=torch.long, device=x.device)
    return logits, labels


@torch.no_grad()
def bank_update(state: BankState, all_x: torch.Tensor, all_y: torch.Tensor,
                m: float) -> BankState:
    """EMA row update and renormalisation of the rows ``all_y`` with the
    features ``all_x`` of every rank, in place.  The rows must be distinct
    (the ``Loader`` gives each index once per global batch): a repeated row
    would make ``index_copy_`` nondeterministic on CUDA, so the check runs
    on the device without a host sync."""
    y = all_y.to(device=state.memory.device, dtype=torch.int64)
    s = torch.sort(y).values
    torch._assert_async((s[1:] != s[:-1]).all(),
                        "bank_update: repeated rows in one global batch")
    w_pos = state.memory.index_select(0, y)
    updated = l2_normalize(w_pos * m + all_x.detach().to(state.memory.dtype) * (1.0 - m),
                           dim=-1)
    state.memory.index_copy_(0, y, updated)
    return state


@dataclass
class CmcBankState:
    """CMC's two banks (JAX ``CmcBankState``)."""
    memory_1: torch.Tensor   # (n_data, dim) modality 1's rows
    memory_2: torch.Tensor   # (n_data, dim) modality 2's rows


def init_cmc_bank(n_data: int, dim: int, generator: Optional[torch.Generator] = None,
                  device="cpu") -> CmcBankState:
    """Two random L2-normalised banks, drawn in turn on the CPU from
    ``generator``."""
    m1 = torch.randn((n_data, dim), generator=generator, dtype=torch.float32)
    m2 = torch.randn((n_data, dim), generator=generator, dtype=torch.float32)
    return CmcBankState(memory_1=l2_normalize(m1, dim=-1).to(device),
                        memory_2=l2_normalize(m2, dim=-1).to(device))


def cmc_bank_logits(state: CmcBankState, x1: torch.Tensor, x2: torch.Tensor,
                    y: torch.Tensor, K: int, T: float,
                    generator: Optional[torch.Generator] = None,
                    idx: Optional[torch.Tensor] = None, rows: Rows = None):
    """(logits1, logits2, labels): one draw of negatives (``idx`` where
    given, else :func:`draw_indices` from ``generator``, a rank's ``rows``
    of the global draw), slot 0 each clip's own row ``y``; ``x1`` against
    ``memory_2``'s rows, ``x2`` against ``memory_1``'s."""
    if idx is None:
        idx = draw_indices(generator, state.memory_1.shape[0], x1.shape[0], K, rows)
    logits1, labels = bank_logits(BankState(state.memory_2), x1, y, K, T, idx=idx)
    logits2, _ = bank_logits(BankState(state.memory_1), x2, y, K, T, idx=idx)
    return logits1, logits2, labels


@torch.no_grad()
def cmc_bank_update(state: CmcBankState, all_x1: torch.Tensor, all_x2: torch.Tensor,
                    all_y: torch.Tensor, m: float) -> CmcBankState:
    """Both memories' EMA row update with the features of every rank, in
    place (:func:`bank_update`)."""
    bank_update(BankState(state.memory_1), all_x1, all_y, m)
    bank_update(BankState(state.memory_2), all_x2, all_y, m)
    return state
