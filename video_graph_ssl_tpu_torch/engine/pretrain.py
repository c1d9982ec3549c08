"""The pretrain steps (counterpart of
``video_graph_ssl_tpu/engine/pretrain.py``: ``make_moco_step``,
``make_simsiam_step``, ``make_bank_step``, ``make_pretrain_step`` and
``make_fused_pretrain_step``).

A MoCo step: on-device SSL augmentation of the raw uint8 two-view batch,
the EMA key pass (BN in train mode, no grad), the query pass, queue logits
and InfoNCE, SGD, the queue enqueue of the keys, then the EMA update mixing
in the *updated* parameters.  A SimSiam step: both views through the model
with gradients (the loss is computed inside it), then SGD; no memory, no
EMA.  A bank step: the first view's features, their logits against ``K``
drawn bank rows plus their own (InfoNCE or the true NCE loss), SGD, then the
EMA update of the clips' bank rows.

Both MoCo passes of a step use the same graph seed, as the JAX step hands
both the same ``step_rngs``; the seed depends on the step (and, inside the
backbone, on the aug point), not on the pass.  SimSiam's two views run in
one JAX ``model.apply``, where each graph block call draws a fresh key, so
the port keys its second view from another stream of the step.

Across ranks (``parallel/``) a step of W ranks, each holding b rows of the
global batch of B = W * b, is the JAX step on the global batch: BN spans
the global batch in both passes, each rank's augmentation and graph noise
are its rows of the global batch's draws, the gradient is the mean over
ranks (``DistributedDataParallel``), the queue takes the gathered keys of
all ranks in rank order, and the metrics are averaged over ranks.  With
``shuffle_bn`` the key pass is ShuffleBN's (``parallel/shuffle_bn.py``).
SimSiam's loss is the mean over a rank's rows, so DDP's average is the
global batch's mean.  The bank step's negatives on a rank are its rows of
the global batch's draw, and the bank takes the gathered features and
indices of all ranks.

Each phase runs under a ``torch.profiler.record_function`` span named in
:data:`PHASES` for the regime (``profile_step.py`` reads their device
time); a span costs a few microseconds of host time when no profiler is
active.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from ..data.transforms_device import make_batch_augment_fn
from ..memory.bank import bank_logits, bank_update, draw_indices
from ..memory.build import criterion_by_name
from ..memory.criterion import nce_softmax_loss
from ..memory.moco import moco_enqueue, moco_logits
from ..models.build import CMC_NOT_PORTED
from ..parallel import dist
from ..parallel.shuffle_bn import shuffle_bn_keys
from ..solver.build import clip_by_global_norm_, grad_clip_norm, set_learning_rate
from .train_state import PretrainState, ema_update

GRAPH_STREAM, AUGMENT_STREAM, SHUFFLE_STREAM = 1, 2, 3
BANK_STREAM, GRAPH_VIEW2_STREAM = 4, 5
# the record_function spans of each regime's step (SimSiam's query_pass runs
# both views)
REGIME_PHASES = {
    "moco": ("augment", "key_pass", "query_pass", "backward", "optimizer", "enqueue_ema"),
    "simsiam": ("augment", "query_pass", "backward", "optimizer"),
    "bank": ("augment", "query_pass", "backward", "optimizer", "bank_update"),
    # engine/downstream.py's fine-tune and linear-probe steps
    "downstream": ("augment", "forward", "backward", "optimizer"),
}
PHASES = tuple(dict.fromkeys(p for ps in REGIME_PHASES.values() for p in ps))


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
    """step(state, clips (b, 2, T, H, W, C) float, lr, index=None) ->
    metrics (``index`` is not read).  With ``shuffle_bn`` the key pass is
    ShuffleBN's, its permutation drawn by ``permutation(state, B)`` (default
    :func:`shuffle_permutation`)."""
    permutation = permutation or shuffle_permutation

    def step(state: PretrainState, clips: torch.Tensor, lr: float,
             index: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
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

        _sgd(state, loss, lr, clip_norm)
        with record_function("enqueue_ema"):
            moco_enqueue(state.contrast, keys if keys is not None
                         else dist.all_gather_rows(feat_k))
            ema_update(model, ema, alpha)
        state.step += 1
        with torch.no_grad():
            return dist.mean_over_ranks(
                {"loss": loss.detach(), **topk_accuracy(logits, labels)})

    return step


def _sgd(state: PretrainState, loss: torch.Tensor, lr: float, clip_norm) -> None:
    """The backward and the optimizer step, each under its span."""
    opt = state.optimizer
    with record_function("backward"):
        opt.zero_grad(set_to_none=True)
        loss.backward()
    with record_function("optimizer"):
        if clip_norm is not None:
            clip_by_global_norm_(state.model.parameters(), clip_norm)
        set_learning_rate(opt, lr)
        opt.step()


def make_simsiam_step(clip_norm=None) -> Callable:
    """step(state, clips (b, 2, T, H, W, C) float, lr, index=None) ->
    {"loss"}: both views through the SimSiam model with gradients, then SGD
    (``index`` is not read)."""

    def step(state: PretrainState, clips: torch.Tensor, lr: float,
             index: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        rows = batch_rows(clips.shape[0])
        state.model.train()
        with record_function("query_pass"):
            seeds = (state.step_seed(GRAPH_STREAM), state.step_seed(GRAPH_VIEW2_STREAM))
            loss = state.query(clips, graph_seed=seeds, graph_rows=rows)
        _sgd(state, loss, lr, clip_norm)
        state.step += 1
        with torch.no_grad():
            return dist.mean_over_ranks({"loss": loss.detach()})

    return step


def bank_draw(state: PretrainState, device, n_data: int, b: int, K: int,
              rows) -> torch.Tensor:
    """This rank's (b, K+1) rows of the step's global negative draw, from
    the step's bank stream on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(state.step_seed(BANK_STREAM))
    return draw_indices(gen, n_data, b, K, rows)


def make_bank_step(K: int, T: float, m: float, criterion: str = "crossentropy",
                   clip_norm=None, draw: Optional[Callable] = None) -> Callable:
    """step(state, clips (b, 2, T, H, W, C) float, lr, index (b,)) ->
    metrics: the first view's features against the bank (``K`` negatives,
    temperature ``T``), loss ``criterion`` (``crossentropy``, or ``NCE``
    with the bank's rows as ``n_data``), SGD, then the bank's EMA update
    with momentum ``m``.  ``draw(state, device, n_data, b, K, rows)`` gives
    the negatives (default :func:`bank_draw`)."""
    draw = draw or bank_draw

    def step(state: PretrainState, clips: torch.Tensor, lr: float,
             index: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if index is None:
            raise ValueError("the bank step needs the batch's dataset indices")
        x = clips[:, 0]
        bank = state.contrast
        n_data = bank.memory.shape[0]
        rows = batch_rows(x.shape[0])
        index = index.to(bank.memory.device)
        idx = draw(state, bank.memory.device, n_data, x.shape[0], K, rows)
        state.model.train()
        with record_function("query_pass"):
            feat = state.query(x, graph_seed=state.step_seed(GRAPH_STREAM), graph_rows=rows)
            logits, labels = bank_logits(bank, feat, index, K, T, idx=idx)
            loss = criterion_by_name(criterion, n_data)(logits)
        _sgd(state, loss, lr, clip_norm)
        with record_function("bank_update"):
            bank_update(bank, dist.all_gather_rows(feat.detach()),
                        dist.all_gather_rows(index), m)
        state.step += 1
        with torch.no_grad():
            return dist.mean_over_ranks(
                {"loss": loss.detach(), **topk_accuracy(logits, labels)})

    return step


def make_pretrain_step(cfg) -> Callable:
    """The step of ``CONTRAST.MEM_TYPE`` on pre-augmented clips:
    step(state, clips, lr, index=None) -> metrics."""
    if cfg.CROSS.MODALITY != "visual":
        raise NotImplementedError(CMC_NOT_PORTED.format(cfg.CROSS.MODALITY))
    mem_type = cfg.CONTRAST.MEM_TYPE
    if mem_type == "simsiam":
        return make_simsiam_step(grad_clip_norm(cfg))
    if mem_type == "moco":
        return make_moco_step(float(cfg.CONTRAST.NCE_T), float(cfg.CONTRAST.ALPHA),
                              grad_clip_norm(cfg), shuffle_bn=bool(cfg.TPU.SHUFFLE_BN))
    if mem_type == "bank":
        return make_bank_step(int(cfg.CONTRAST.NCE_K), float(cfg.CONTRAST.NCE_T),
                              float(cfg.CONTRAST.NCE_M), cfg.CROSS.CRITERION,
                              grad_clip_norm(cfg))
    raise NotImplementedError(f"Unknown Contrast type {mem_type}!")


def make_fused_pretrain_step(cfg) -> Callable:
    """step(state, raw_clips (b, 2, T, H, W, C) uint8, lr, index=None) ->
    metrics, with the SSL augmentation drawn on the clips' device from the
    step seed; ``index`` (b,), the clips' dataset indices, feeds the bank."""
    inner = make_pretrain_step(cfg)
    augment = make_batch_augment_fn(cfg, "ssl")

    def step(state: PretrainState, raw_clips: torch.Tensor, lr: float,
             index: Optional[torch.Tensor] = None):
        gen = torch.Generator(device=raw_clips.device)
        gen.manual_seed(state.step_seed(AUGMENT_STREAM))
        with record_function("augment"), torch.no_grad():
            clips = augment(gen, raw_clips, batch_rows(raw_clips.shape[0]))
        return inner(state, clips, lr, index)

    return step
