"""Contrast-memory factory (the MoCo branch of
``video_graph_ssl_tpu/memory/build.py``)."""

from __future__ import annotations

import torch

from .moco import MocoState, init_moco


def create_contrast(cfg, device="cpu") -> MocoState:
    """MoCo queue of ``CONTRAST.NCE_K`` x ``CROSS.FEAT_DIM``, drawn from
    ``MODEL.SEED + 1``."""
    if cfg.CONTRAST.MEM_TYPE != "moco" or cfg.CROSS.MODALITY != "visual":
        raise NotImplementedError(
            f"only the visual MoCo memory is ported, got "
            f"{cfg.CROSS.MODALITY}/{cfg.CONTRAST.MEM_TYPE}")
    gen = torch.Generator().manual_seed(int(cfg.MODEL.SEED) + 1)
    return init_moco(int(cfg.CONTRAST.NCE_K), int(cfg.CROSS.FEAT_DIM), gen,
                     device)
