"""The downstream steps (counterpart of ``video_graph_ssl_tpu/engine/downstream.py``):
fine-tune and linear-probe training, evaluation and feature extraction.

A train step: the ``VideoModel``'s logits, cross-entropy, SGD at the
epoch's lr, top-1/top-5.  ``bn_train=True`` runs the model in train mode:
partial BN (every BN after ``stem_0`` on its running statistics, unless
``MODEL.NO_PARTIALBN``), the features' dropout and the graph blocks'
sampling, keyed on the step's graph stream.  ``bn_train=False`` (the linear
probe under ``MODEL.PROBE_BN eval``) runs the whole model in eval mode: no
dropout, no graph sampling, every BN on its running statistics, as the JAX
step's ``train=False`` does.  The linear probe's state trains ``new_fc``
alone (``engine/build.py:create_downstream_state``), so its encoder takes
no backward.

Across ranks (``parallel/``) a train step of W ranks, each holding b rows
of the global batch of B = W * b, is the one-process step on the global
batch: the model runs through ``state.query`` (``DistributedDataParallel``
over the trainable parameters, so the gradient is the mean over ranks), the
BNs that stay live (``stem_0``'s and the graph blocks' under partial BN)
take the global batch's statistics, the ``train`` augmentation, the graph
noise and the features' dropout are the rank's rows of the global batch's
draws, and the metrics are averaged over ranks.

The eval, fused-eval and feature steps run the model in eval mode under
``torch.no_grad()``, on whatever rows they are given (the tools share a
batch out with ``parallel.dist.eval_over_ranks``).  Each train phase runs
under a ``torch.profiler.record_function`` span of
``REGIME_PHASES['downstream']``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..data.transforms_device import make_batch_augment_fn
from ..parallel import dist
from ..solver.build import grad_clip_norm
from .pretrain import GRAPH_STREAM, _sgd, batch_rows, topk_accuracy
from .train_state import PretrainState

# the downstream ``train`` augmentation's stream (JAX folds in 13)
TRAIN_AUGMENT_STREAM = 13


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy in fp32 (JAX ``cross_entropy_loss``)."""
    return F.cross_entropy(logits.float(), labels.long())


def make_downstream_train_step(bn_train: bool = True, clip_norm=None) -> Callable:
    """step(state, clips (b, T, H, W, C) float, labels (b,), lr) ->
    {"loss", "top1", "top5"}."""

    def step(state: PretrainState, clips: torch.Tensor, labels: torch.Tensor,
             lr: float) -> Dict[str, torch.Tensor]:
        state.model.train(bn_train)
        with record_function("forward"):
            logits = state.query(clips, graph_seed=state.step_seed(GRAPH_STREAM),
                                 graph_rows=batch_rows(clips.shape[0]))
            loss = cross_entropy_loss(logits, labels)
        _sgd(state, loss, lr, clip_norm)
        state.step += 1
        with torch.no_grad():
            return dist.mean_over_ranks(
                {"loss": loss.detach(), **topk_accuracy(logits.detach(), labels)})

    return step


def make_fused_downstream_step(cfg, bn_train: bool = True) -> Callable:
    """step(state, raw_clips (b, T, H, W, C) uint8, labels (b,), lr) ->
    metrics, with the ``train`` augmentation drawn on the clips' device
    from the step's own stream (a rank's rows of the global batch's draw)."""
    inner = make_downstream_train_step(bn_train, grad_clip_norm(cfg))
    augment = make_batch_augment_fn(cfg, "train")

    def step(state: PretrainState, raw_clips: torch.Tensor, labels: torch.Tensor,
             lr: float) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=raw_clips.device)
        gen.manual_seed(state.step_seed(TRAIN_AUGMENT_STREAM))
        with record_function("augment"), torch.no_grad():
            clips = augment(gen, raw_clips, batch_rows(raw_clips.shape[0]))
        return inner(state, clips, labels, lr)

    return step


def make_eval_step() -> Callable:
    """fn(model, clips (B, T, H, W, C)) -> logits, eval mode, no grad."""

    @torch.no_grad()
    def step(model: torch.nn.Module, clips: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(clips)

    return step


def make_fused_eval_step(cfg) -> Callable:
    """fn(model, raw_clips (B, T, H, W, C) uint8) -> logits, with the
    ``eval`` chain (resize, centre crop, normalise) on the device."""
    augment = make_batch_augment_fn(cfg, "eval")
    inner = make_eval_step()
    return lambda model, raw_clips: inner(model, augment(raw_clips))


def make_feature_step() -> Callable:
    """fn(model, clips) -> the encoder's features (``model.encode``), eval
    mode, no grad."""

    @torch.no_grad()
    def step(model: torch.nn.Module, clips: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model.encode(clips)

    return step
