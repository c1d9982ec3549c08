"""The GCA MoCo pretrain step (counterpart of
``video_graph_ssl_tpu/engine/pretrain.py``: ``make_moco_step`` and
``make_fused_pretrain_step``).

One step: on-device SSL augmentation of the raw uint8 two-view batch, the
EMA key pass (BN in train mode, no grad), the query pass, queue logits and
InfoNCE, SGD, the queue enqueue of the keys, then the EMA update mixing in
the *updated* parameters.

Both passes of a step use the same graph seed, as the JAX step hands both
the same ``step_rngs``; the seed depends on the step (and, inside the
backbone, on the aug point), not on the pass.

Across ranks (``parallel/``) a step of W ranks, each holding b rows of the
global batch of B = W * b, is the JAX step on the global batch: BN spans
the global batch in both passes, each rank's augmentation and graph noise
are its rows of the global batch's draws, the gradient is the mean over
ranks (``DistributedDataParallel``), the queue takes the gathered keys of
all ranks in rank order, and the metrics are averaged over ranks.  With
``shuffle_bn`` the key pass is ShuffleBN's (``parallel/shuffle_bn.py``).

Each phase runs under a ``torch.profiler.record_function`` span named in
:data:`PHASES` (``profile_step.py`` reads their device time); a span costs
a few microseconds of host time when no profiler is active.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from ..data.transforms_device import make_batch_augment_fn
from ..memory.criterion import nce_softmax_loss
from ..memory.moco import moco_enqueue, moco_logits
from ..models.layers import FUSED_ACROSS_RANKS
from ..parallel import dist
from ..parallel.shuffle_bn import shuffle_bn_keys
from ..solver.build import grad_clip_norm, set_learning_rate
from .train_state import PretrainState, ema_update

GRAPH_STREAM, AUGMENT_STREAM, SHUFFLE_STREAM = 1, 2, 3
PHASES = ("augment", "key_pass", "query_pass", "backward", "optimizer",
          "enqueue_ema")


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks=(1, 5)) -> Dict[str, torch.Tensor]:
    """top-k accuracy in percent by rank counting: the label is in the top
    k iff (#greater logits) + (#equal logits at an earlier index) < k, the
    placement of a stable descending sort."""
    pos = logits.gather(1, labels[:, None])
    idx = torch.arange(logits.shape[-1], device=logits.device)
    greater = (logits > pos).sum(dim=-1)
    ties_before = ((logits == pos) & (idx[None] < labels[:, None])).sum(dim=-1)
    rank = greater + ties_before
    return {f"top{k}": (rank < k).float().mean() * 100.0 for k in ks}


def shuffle_permutation(state: PretrainState, n: int) -> torch.Tensor:
    """ShuffleBN's permutation of the step's global batch, from the step's
    own stream (the same on every rank)."""
    g = torch.Generator().manual_seed(state.step_seed(SHUFFLE_STREAM))
    return torch.randperm(n, generator=g)


def batch_rows(b: int):
    """(row0, global B) of this rank's b rows."""
    return dist.rank() * b, dist.world_size() * b


def make_moco_step(T: float, alpha: float, clip_norm=None, shuffle_bn: bool = False,
                   permutation: Optional[Callable] = None) -> Callable:
    """step(state, clips (b, 2, T, H, W, C) float, lr) -> metrics.  With
    ``shuffle_bn`` the key pass is ShuffleBN's, its permutation drawn by
    ``permutation(state, B)`` (default :func:`shuffle_permutation`)."""
    permutation = permutation or shuffle_permutation

    def step(state: PretrainState, clips: torch.Tensor, lr: float
             ) -> Dict[str, torch.Tensor]:
        x1, x2 = clips[:, 0], clips[:, 1]
        seed = state.step_seed(GRAPH_STREAM)
        model, ema = state.model, state.ema_model
        rows = batch_rows(x1.shape[0])

        # Key pass: EMA weights, BN in train mode (updates the EMA stats).
        ema.train()
        with record_function("key_pass"), torch.no_grad():
            if shuffle_bn:
                keys = shuffle_bn_keys(ema, x2, seed, permutation(state, rows[1]))
                feat_k = keys[rows[0]:rows[0] + x2.shape[0]]
            else:
                feat_k = ema(x2, graph_seed=seed, graph_rows=rows)
                keys = None

        model.train()
        with record_function("query_pass"):
            feat_q = state.query(x1, graph_seed=seed, graph_rows=rows)
            logits, labels = moco_logits(feat_q, feat_k, state.contrast.queue, T)
            loss = nce_softmax_loss(logits)

        opt = state.optimizer
        with record_function("backward"):
            opt.zero_grad(set_to_none=True)
            loss.backward()
        with record_function("optimizer"):
            if clip_norm is not None:
                torch.nn.utils.clip_grad_norm_(model.parameters(), clip_norm)
            set_learning_rate(opt, lr)
            opt.step()

        with record_function("enqueue_ema"):
            moco_enqueue(state.contrast, keys if keys is not None
                         else dist.all_gather_rows(feat_k))
            ema_update(model, ema, alpha)
        state.step += 1
        with torch.no_grad():
            return dist.mean_over_ranks(
                {"loss": loss.detach(), **topk_accuracy(logits, labels)})

    return step


def make_fused_pretrain_step(cfg) -> Callable:
    """step(state, raw_clips (b, 2, T, H, W, C) uint8, lr) -> metrics, with
    the SSL augmentation drawn on the clips' device from the step seed."""
    if cfg.CONTRAST.MEM_TYPE != "moco":
        raise NotImplementedError(f"pretrain regime {cfg.CONTRAST.MEM_TYPE} "
                                  "is not ported yet (moco is)")
    if cfg.TPU.SEPCONV_FUSED and dist.world_size() > 1:
        raise NotImplementedError(FUSED_ACROSS_RANKS)
    inner = make_moco_step(float(cfg.CONTRAST.NCE_T), float(cfg.CONTRAST.ALPHA),
                           grad_clip_norm(cfg), shuffle_bn=bool(cfg.TPU.SHUFFLE_BN))
    augment = make_batch_augment_fn(cfg, "ssl")

    def step(state: PretrainState, raw_clips: torch.Tensor, lr: float):
        gen = torch.Generator(device=raw_clips.device)
        gen.manual_seed(state.step_seed(AUGMENT_STREAM))
        with record_function("augment"), torch.no_grad():
            clips = augment(gen, raw_clips, batch_rows(raw_clips.shape[0]))
        return inner(state, clips, lr)

    return step
