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

Each phase runs under a ``torch.profiler.record_function`` span named in
:data:`PHASES` (``profile_step.py`` reads their device time); a span costs
a few microseconds of host time when no profiler is active.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.profiler import record_function

from ..data.transforms_device import make_batch_augment_fn
from ..memory.criterion import nce_softmax_loss
from ..memory.moco import moco_enqueue, moco_logits
from ..solver.build import grad_clip_norm, set_learning_rate
from .train_state import PretrainState, ema_update

GRAPH_STREAM, AUGMENT_STREAM = 1, 2
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


def make_moco_step(T: float, alpha: float, clip_norm=None) -> Callable:
    """step(state, clips (B, 2, T, H, W, C) float, lr) -> metrics."""

    def step(state: PretrainState, clips: torch.Tensor, lr: float
             ) -> Dict[str, torch.Tensor]:
        x1, x2 = clips[:, 0], clips[:, 1]
        seed = state.step_seed(GRAPH_STREAM)
        model, ema = state.model, state.ema_model

        # Key pass: EMA weights, BN in train mode (updates the EMA stats).
        ema.train()
        with record_function("key_pass"), torch.no_grad():
            feat_k = ema(x2, graph_seed=seed)

        model.train()
        with record_function("query_pass"):
            feat_q = model(x1, graph_seed=seed)
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
            moco_enqueue(state.contrast, feat_k)
            ema_update(model, ema, alpha)
        state.step += 1
        with torch.no_grad():
            return {"loss": loss.detach(), **topk_accuracy(logits, labels)}

    return step


def make_fused_pretrain_step(cfg) -> Callable:
    """step(state, raw_clips (B, 2, T, H, W, C) uint8, lr) -> metrics, with
    the SSL augmentation drawn on the clips' device from the step seed."""
    if cfg.CONTRAST.MEM_TYPE != "moco":
        raise NotImplementedError(f"pretrain regime {cfg.CONTRAST.MEM_TYPE} "
                                  "is not ported yet (moco is)")
    inner = make_moco_step(float(cfg.CONTRAST.NCE_T), float(cfg.CONTRAST.ALPHA),
                           grad_clip_norm(cfg))
    augment = make_batch_augment_fn(cfg, "ssl")

    def step(state: PretrainState, raw_clips: torch.Tensor, lr: float):
        gen = torch.Generator(device=raw_clips.device)
        gen.manual_seed(state.step_seed(AUGMENT_STREAM))
        with record_function("augment"), torch.no_grad():
            clips = augment(gen, raw_clips)
        return inner(state, clips, lr)

    return step
