"""Contrast-memory and criterion factories (counterpart of
``video_graph_ssl_tpu/memory/build.py``)."""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, Optional, Union

import torch

from ..models.build import is_cmc
from .bank import BankState, CmcBankState, init_bank, init_cmc_bank
from .criterion import nce_criterion, nce_softmax_loss
from .moco import CmcMocoState, MocoState, init_cmc_moco, init_moco

Contrast = Union[MocoState, BankState, CmcMocoState, CmcBankState]


def create_contrast(cfg, device="cpu", n_data: int = 0) -> Optional[Contrast]:
    """The regime's initial memory, drawn on the CPU from ``MODEL.SEED + 1``:
    a MoCo queue of ``CONTRAST.NCE_K`` x ``CROSS.FEAT_DIM`` (``moco``), a
    bank of ``n_data`` x ``CROSS.FEAT_DIM`` (``bank``), or None
    (``simsiam`` needs no memory); under CMC (``CROSS.MODALITY`` other than
    ``visual``) two of them, one per modality (``CmcMocoState``,
    ``CmcBankState``)."""
    mem_type = cfg.CONTRAST.MEM_TYPE
    dim = int(cfg.CROSS.FEAT_DIM)
    gen = torch.Generator().manual_seed(int(cfg.MODEL.SEED) + 1)
    cmc = is_cmc(cfg)
    if mem_type == "moco":
        return (init_cmc_moco if cmc else init_moco)(int(cfg.CONTRAST.NCE_K), dim, gen,
                                                     device)
    if mem_type == "bank":
        if int(n_data) < 1:
            raise ValueError(f"the memory bank needs the dataset size, got n_data {n_data}")
        return (init_cmc_bank if cmc else init_bank)(int(n_data), dim, gen, device)
    if mem_type == "simsiam":
        return None
    raise ValueError(f"Unknown CONTRAST.MEM_TYPE: {mem_type}")


def contrast_fields(contrast: Contrast) -> Dict[str, Any]:
    """The memory's fields by their JAX names (``queue``, ``ptr``;
    ``memory``; ``queue_1``, ``queue_2``, ``ptr``; ``memory_1``,
    ``memory_2``): the live tensors and the int pointer."""
    return {f.name: getattr(contrast, f.name) for f in dataclasses.fields(contrast)}


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
