"""MoCo queue (counterpart of ``video_graph_ssl_tpu/memory/moco.py``).

The queue is a ``(K, dim)`` device tensor and an integer ring pointer; the
enqueue writes in place (the JAX package donates its state for the same
effect).
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
