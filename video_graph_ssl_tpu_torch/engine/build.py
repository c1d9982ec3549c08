"""State construction (counterpart of ``video_graph_ssl_tpu/engine/build.py``:
``create_pretrain_state``, ``create_downstream_state`` and
``linear_probe_mask``)."""

from __future__ import annotations

import copy

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..memory.build import contrast_fields, create_contrast
from ..models.layers import place
from ..parallel import dist
from ..solver.build import make_optimizer
from .train_state import PretrainState


def _replicated_ddp(model: nn.Module, device: torch.device, what: str, extra=()):
    """Under a process group: check that every rank holds the same state
    (rank 0's broadcast against each rank's own, bit for bit), then wrap
    ``model`` in ``DistributedDataParallel`` over its trainable parameters,
    without buffer broadcasts (the live BN statistics are already the global
    batch's on every rank).  None without a group."""
    if not dist.is_distributed():
        return None
    dist.check_replicated([*model.state_dict().values(), *extra], what)
    ids = None
    if device.type == "cuda":
        ids = [device.index if device.index is not None else torch.cuda.current_device()]
    return DistributedDataParallel(model, device_ids=ids, broadcast_buffers=False)


def create_pretrain_state(cfg, model: nn.Module, device, n_data: int = 0) -> PretrainState:
    """Move ``model`` to ``device`` (``layers.place``: channels_last_3d for
    3D kernels, channels_last for 2D ones) and build the
    optimizer and the regime's memory: for ``moco`` the EMA encoder (a copy
    of ``model``) and the queue, for ``bank`` a bank of ``n_data`` rows (no
    EMA), for ``simsiam`` neither; under CMC the EMA copy holds both stacks
    and the memory is two queues or two banks.

    Under a process group every rank built the same model and memory from
    ``MODEL.SEED``: that is checked once (rank 0's broadcast against each
    rank's own, bit for bit), and the query model is wrapped in
    ``DistributedDataParallel`` without buffer broadcasts, as its BN
    statistics are already the global batch's on every rank.  The EMA
    encoder takes no gradient and is not wrapped."""
    device = torch.device(device)
    model = place(model, device)
    ema = None
    if cfg.CONTRAST.MEM_TYPE == "moco":
        # The EMA encoder starts as an exact copy of the query encoder.
        ema = copy.deepcopy(model)
        for p in ema.parameters():
            p.requires_grad_(False)
    contrast = create_contrast(cfg, device, n_data)
    memory = [] if contrast is None else [
        v for v in contrast_fields(contrast).values() if isinstance(v, torch.Tensor)]
    ddp = _replicated_ddp(model, device, "the initial parameters, BN statistics and memory",
                          memory)
    return PretrainState(
        model=model,
        ema_model=ema,
        optimizer=make_optimizer(cfg, model),
        contrast=contrast,
        seed=int(cfg.MODEL.SEED) + 2,
        ddp=ddp,
    )


def is_probe_param(name: str) -> bool:
    """The linear probe trains ``new_fc`` alone (JAX ``linear_probe_mask``)."""
    return name.split(".", 1)[0] == "new_fc"


def create_downstream_state(cfg, model: nn.Module, device) -> PretrainState:
    """The fine-tune / linear-probe state: ``model`` (a ``VideoModel``) on
    ``device`` (``layers.place``), SGD over all its parameters or, with
    ``MODEL.LINEAR_PROBE``, over ``new_fc``'s alone, the encoder's taking no
    gradient (so no encoder backward runs); no EMA encoder and no memory.
    The seed is the JAX state's, ``MODEL.SEED + 2``.

    Under a process group ``model`` must already hold what every rank
    trains from (the checkpoint surgery comes first): that is checked, and
    the model is wrapped in ``DistributedDataParallel`` over its trainable
    parameters (``new_fc``'s alone for the probe), as for pretraining."""
    device = torch.device(device)
    model = place(model, device)
    trainable = is_probe_param if bool(cfg.MODEL.LINEAR_PROBE) else None
    if trainable is not None:
        for name, p in model.named_parameters():
            p.requires_grad_(trainable(name))
    return PretrainState(model=model, ema_model=None,
                         optimizer=make_optimizer(cfg, model, trainable),
                         contrast=None, seed=int(cfg.MODEL.SEED) + 2,
                         ddp=_replicated_ddp(model, device,
                                             "the initial parameters and BN statistics"))
