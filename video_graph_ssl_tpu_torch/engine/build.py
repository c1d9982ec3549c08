"""Pretrain-state construction (counterpart of
``video_graph_ssl_tpu/engine/build.py:create_pretrain_state``)."""

from __future__ import annotations

import copy

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..memory.build import create_contrast
from ..parallel import dist
from ..solver.build import make_optimizer
from .train_state import PretrainState


def create_pretrain_state(cfg, model: nn.Module, device, n_data: int = 0) -> PretrainState:
    """Move ``model`` to ``device`` (channels_last_3d) and build the
    optimizer and the regime's memory: for ``moco`` the EMA encoder (a copy
    of ``model``) and the queue, for ``bank`` a bank of ``n_data`` rows (no
    EMA), for ``simsiam`` neither.

    Under a process group every rank built the same model and memory from
    ``MODEL.SEED``: that is checked once (rank 0's broadcast against each
    rank's own, bit for bit), and the query model is wrapped in
    ``DistributedDataParallel`` without buffer broadcasts, as its BN
    statistics are already the global batch's on every rank.  The EMA
    encoder takes no gradient and is not wrapped."""
    device = torch.device(device)
    model = model.to(device=device, memory_format=torch.channels_last_3d)
    ema = None
    if cfg.CONTRAST.MEM_TYPE == "moco":
        # The EMA encoder starts as an exact copy of the query encoder.
        ema = copy.deepcopy(model)
        for p in ema.parameters():
            p.requires_grad_(False)
    contrast = create_contrast(cfg, device, n_data)
    ddp = None
    if dist.is_distributed():
        memory = [] if contrast is None else [
            contrast.queue if hasattr(contrast, "queue") else contrast.memory]
        dist.check_replicated([*model.state_dict().values(), *memory],
                              "the initial parameters, BN statistics and memory")
        ids = None
        if device.type == "cuda":
            ids = [device.index if device.index is not None else torch.cuda.current_device()]
        ddp = DistributedDataParallel(model, device_ids=ids, broadcast_buffers=False)
    return PretrainState(
        model=model,
        ema_model=ema,
        optimizer=make_optimizer(cfg, model),
        contrast=contrast,
        seed=int(cfg.MODEL.SEED) + 2,
        ddp=ddp,
    )
