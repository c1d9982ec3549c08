"""MoCo queue (counterpart of ``video_graph_ssl_tpu/memory/moco.py``).

The queue is a ``(K, dim)`` device tensor and an integer ring pointer; the
enqueue writes in place (the JAX package donates its state for the same
effect).  CMC's dual queue (``CmcMocoState``) holds one queue per modality
and one pointer for both; each modality's queries are scored against the
other modality's keys and queue.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..models.heads import l2_normalize


@dataclass
class MocoState:
    queue: torch.Tensor   # (K, dim) L2-normalised keys
    ptr: int = 0          # ring pointer


def init_moco(K: int, dim: int, generator: Optional[torch.Generator] = None,
              device="cpu") -> MocoState:
    """Random L2-normalised queue, drawn on the CPU from ``generator``."""
    q = torch.randn((K, dim), generator=generator, dtype=torch.float32)
    return MocoState(queue=l2_normalize(q, dim=-1).to(device), ptr=0)


def moco_logits(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor,
                T: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """[pos; negs] / T with the positive at column 0 and label 0."""
    k = k.detach()
    pos = torch.sum(q * k, dim=-1, keepdim=True)
    neg = q @ queue.t()
    logits = torch.cat([pos, neg], dim=1) / T
    labels = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
    return logits, labels


@torch.no_grad()
def moco_enqueue(state: MocoState, keys: torch.Tensor) -> MocoState:
    """Ring-buffer enqueue of the key batch, in place."""
    n, K = keys.shape[0], state.queue.shape[0]
    idx = (state.ptr + torch.arange(n, device=keys.device)) % K
    state.queue.index_copy_(0, idx, keys.detach().to(state.queue.dtype))
    state.ptr = (state.ptr + n) % K
    return state


@dataclass
class CmcMocoState:
    """CMC's two queues (JAX ``CmcMocoState``), one ring pointer for both."""
    queue_1: torch.Tensor   # (K, dim) modality 1's keys
    queue_2: torch.Tensor   # (K, dim) modality 2's keys
    ptr: int = 0


def init_cmc_moco(K: int, dim: int, generator: Optional[torch.Generator] = None,
                  device="cpu") -> CmcMocoState:
    """Two random L2-normalised queues, drawn in turn on the CPU from
    ``generator``."""
    q1 = torch.randn((K, dim), generator=generator, dtype=torch.float32)
    q2 = torch.randn((K, dim), generator=generator, dtype=torch.float32)
    return CmcMocoState(queue_1=l2_normalize(q1, dim=-1).to(device),
                        queue_2=l2_normalize(q2, dim=-1).to(device), ptr=0)


def cmc_moco_forward(state: CmcMocoState, q1: torch.Tensor, k1: torch.Tensor,
                     q2: torch.Tensor, k2: torch.Tensor, T: float):
    """(logits1, logits2, labels): ``q1`` against ``k2`` and ``queue_2``,
    ``q2`` against ``k1`` and ``queue_1``."""
    logits1, labels = moco_logits(q1, k2, state.queue_2, T)
    logits2, _ = moco_logits(q2, k1, state.queue_1, T)
    return logits1, logits2, labels


@torch.no_grad()
def cmc_moco_enqueue(state: CmcMocoState, keys_1: torch.Tensor,
                     keys_2: torch.Tensor) -> CmcMocoState:
    """Both modalities' key batches into their queues at the one pointer, in
    place."""
    n, K = keys_1.shape[0], state.queue_1.shape[0]
    idx = (state.ptr + torch.arange(n, device=keys_1.device)) % K
    state.queue_1.index_copy_(0, idx, keys_1.detach().to(state.queue_1.dtype))
    state.queue_2.index_copy_(0, idx, keys_2.detach().to(state.queue_2.dtype))
    state.ptr = (state.ptr + n) % K
    return state
