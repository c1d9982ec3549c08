"""Pretrain-state construction (counterpart of
``video_graph_ssl_tpu/engine/build.py:create_pretrain_state``)."""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..memory.build import create_contrast
from ..solver.build import make_optimizer
from .train_state import PretrainState


def create_pretrain_state(cfg, model: nn.Module, device) -> PretrainState:
    """Move ``model`` to ``device`` (channels_last_3d), copy it into the EMA
    encoder, and build the optimizer and the MoCo queue."""
    device = torch.device(device)
    model = model.to(device=device, memory_format=torch.channels_last_3d)
    # The EMA encoder starts as an exact copy of the query encoder.
    ema = copy.deepcopy(model)
    for p in ema.parameters():
        p.requires_grad_(False)
    return PretrainState(
        model=model,
        ema_model=ema,
        optimizer=make_optimizer(cfg, model),
        contrast=create_contrast(cfg, device),
        seed=int(cfg.MODEL.SEED) + 2,
    )
