"""Model factory (counterpart of ``video_graph_ssl_tpu/models/build.py``)
for the backbones ported so far: S3D and tiny3d, 3D, RGB."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .layers import init_params_
from .s3d import S3D, S3D_FEATURE_DIM
from .tiny import TINY3D_FEATURE_DIM, Tiny3D
from .wrappers import ContrastWrapper, GraphWrapper, VisualEncoder

# name -> (ctor, feature_dim, default graph-aug points)
BACKBONES_3D = {
    "S3D": (S3D, S3D_FEATURE_DIM, (5, 9, 14)),
    "tiny3d": (Tiny3D, TINY3D_FEATURE_DIM, (1,)),
}


def compute_dtype(cfg) -> torch.dtype:
    """``TPU.COMPUTE_DTYPE``; float64 exists for CPU parity tests (the CUDA
    kernels take fp32 and bf16)."""
    name = str(cfg.TPU.COMPUTE_DTYPE)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32,
              "float64": torch.float64}
    if name not in dtypes:
        raise ValueError(f"TPU.COMPUTE_DTYPE must be one of {sorted(dtypes)}, "
                         f"got {name}")
    return dtypes[name]


def graph_cfg_from(cfg) -> Dict[str, Any]:
    """GRAPH section -> TemporalGraphAug kwargs (USE_PALLAS and
    PROPAGATE_PALLAS are TPU choices and are not read)."""
    g = cfg.GRAPH
    return dict(max_hop=g.MAX_HOP, num_gcn_layers=g.NUM_GCN_LAYERS,
                temperature=g.TEMPERATURE, alpha=g.ALPHA,
                sub_sample=g.SUB_SAMPLE, max_pool=g.MAX_POOL,
                bn_layer=g.BN_LAYER, sampler=g.SAMPLER,
                mask_frame=g.MASK_FRAME, nei_size=g.NEI_SIZE)


def create_visual_model(cfg, seed: int = None) -> Tuple[GraphWrapper, int]:
    """The SSL pretraining model, initialised on the CPU from
    ``MODEL.SEED`` (or ``seed``); returns (module, backbone feature dim)."""
    name = cfg.MODEL.BACKBONE
    if cfg.MODEL.BACKBONE_TYPE != "3D" or name not in BACKBONES_3D:
        raise NotImplementedError(
            f"backbone {cfg.MODEL.BACKBONE_TYPE}/{name} is not ported yet "
            f"(have 3D: {sorted(BACKBONES_3D)})")
    if cfg.INPUT.MODALITY != "RGB" or int(cfg.INPUT.NEW_LENGTH) not in (-1, 1):
        raise NotImplementedError("only RGB clips with NEW_LENGTH 1 are ported")
    if cfg.CROSS.MODALITY != "visual" or cfg.CONTRAST.MEM_TYPE != "moco":
        raise NotImplementedError(
            f"only the visual MoCo regime is ported, got "
            f"{cfg.CROSS.MODALITY}/{cfg.CONTRAST.MEM_TYPE}")
    ctor, feat_dim, default_aug = BACKBONES_3D[name]
    aug = bool(cfg.MODEL.AUG_FLAG)
    extra = {}
    if bool(cfg.TPU.SEPCONV_FUSED):
        if name != "S3D":
            raise ValueError(f"TPU.SEPCONV_FUSED only applies to S3D, got {name}")
        extra["fused_sepconv"] = True
    backbone = ctor(
        aug_points=(tuple(cfg.GRAPH.AUG_POINTS) or default_aug) if aug else (),
        graph_cfg=graph_cfg_from(cfg) if aug else None,
        dtype=compute_dtype(cfg), **extra)
    encoder = VisualEncoder(backbone, float(cfg.MODEL.DROPOUT))
    model = GraphWrapper(ContrastWrapper(encoder, feat_dim,
                                         int(cfg.CROSS.FEAT_DIM),
                                         cfg.CROSS.HEAD_TYPE))
    gen = torch.Generator().manual_seed(int(cfg.MODEL.SEED if seed is None else seed))
    init_params_(model, gen)
    return model, feat_dim
