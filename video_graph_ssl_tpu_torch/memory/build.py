"""Contrast-memory and criterion factories (the visual branches of
``video_graph_ssl_tpu/memory/build.py``)."""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Union

import torch

from ..models.build import CMC_NOT_PORTED
from .bank import BankState, init_bank
from .criterion import nce_criterion, nce_softmax_loss
from .moco import MocoState, init_moco


def create_contrast(cfg, device="cpu", n_data: int = 0
                    ) -> Optional[Union[MocoState, BankState]]:
    """The regime's initial memory, drawn on the CPU from ``MODEL.SEED + 1``:
    a MoCo queue of ``CONTRAST.NCE_K`` x ``CROSS.FEAT_DIM`` (``moco``), a
    bank of ``n_data`` x ``CROSS.FEAT_DIM`` (``bank``), or None
    (``simsiam`` needs no memory)."""
    if cfg.CROSS.MODALITY != "visual":
        raise NotImplementedError(CMC_NOT_PORTED.format(cfg.CROSS.MODALITY))
    mem_type = cfg.CONTRAST.MEM_TYPE
    dim = int(cfg.CROSS.FEAT_DIM)
    gen = torch.Generator().manual_seed(int(cfg.MODEL.SEED) + 1)
    if mem_type == "moco":
        return init_moco(int(cfg.CONTRAST.NCE_K), dim, gen, device)
    if mem_type == "bank":
        if int(n_data) < 1:
            raise ValueError(f"the memory bank needs the dataset size, got n_data {n_data}")
        return init_bank(int(n_data), dim, gen, device)
    if mem_type == "simsiam":
        return None
    raise ValueError(f"Unknown CONTRAST.MEM_TYPE: {mem_type}")


def create_criterion(cfg, n_data: int) -> Callable:
    """The loss of ``CROSS.CRITERION`` over (B, K+1) logits."""
    return criterion_by_name(cfg.CROSS.CRITERION, n_data)


def criterion_by_name(name: str, n_data: int) -> Callable:
    """The loss named ``name`` (a ``CROSS.CRITERION`` value) over (B, K+1)
    logits; SimSiam computes its loss inside the model
    (``models.wrappers.simsiam_d``)."""
    if name == "crossentropy":
        return lambda logits, labels=None: nce_softmax_loss(logits)
    if name == "NCE":
        return partial(nce_criterion, n_data=int(n_data))
    raise ValueError(f"Unknown CROSS.CRITERION: {name}")
