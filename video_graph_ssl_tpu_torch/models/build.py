"""Model factory (counterpart of ``video_graph_ssl_tpu/models/build.py``):
the backbones ported so far, the visual pretrain regimes
(``CONTRAST.MEM_TYPE`` moco, bank, simsiam) and the downstream classifier
(``create_video_model``).

3D: the reference's exported S3D, S3DG, I3D and InceptionI3d,
the 3D ResNets ``resnet3d_{10..200}``, the factorized ``resnet_i3d_{18,50,
101}`` and ``resnet2p1d_{10..200}``, ``i3d_res50_nonlocal`` (non-local
blocks on layer2.1 and layer2.3), and the test backbone tiny3d: every name
of JAX's ``BACKBONES_3D``; and ``slowfast_r50`` (SlowFast-R50 8x8, graph
blocks on its Fast pathway), which the JAX package does not have.  2D
(``MODEL.BACKBONE_TYPE 2D``, frames folded into the batch and aggregated
under ``MODEL.POOLING_TYPE``): ``resnet18`` .. ``resnet152``,
``bninception`` and ``inception_v3``; a 2D backbone builds no graph block,
whatever ``MODEL.AUG_FLAG`` says, as in JAX.

``INPUT.MODALITY`` RGB, Flow or RGBDiff with ``INPUT.NEW_LENGTH`` stacked
frames per time step (-1: 1 for RGB, 5 otherwise) sets the stem's input
channels: 3 x new_length for RGB and for RGBDiff (after the difference of
its new_length + 1 groups), 2 x new_length for Flow (JAX infers them from
the input).

``CROSS.MODALITY`` other than ``visual`` (CMC, moco or bank) builds
``CmcWrapper``: two encoder + head stacks of the same config, the second on
the clips' temporal differences.

The TPU layouts: ``TPU.REMAT``/``TPU.REMAT_POLICY`` and ``TPU.STEM_S2D`` are
validated as JAX validates them (the same ``ValueError``s).  A valid
``TPU.REMAT True`` reaches every 3D backbone as ``remat`` (``models/
remat.py``; tiny3d and ``i3d_res50_nonlocal`` take it unread, and the 2D
backbones never see it, as in JAX); a valid ``TPU.STEM_S2D`` other than
off builds S3D's and S3DG's stage 0 as the space-to-depth stem
(``layers.SepConvS2D``), "full" or "spatial"."""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from ..data.build import resolve_new_length
from . import resnet2d
from .bninception import BNINCEPTION_FEATURE_DIM, bninception
from .i3d import I3D, I3D_FEATURE_DIM
from .i3dnon import I3DNON_FEATURE_DIM, i3d_res50_nonlocal
from .inceptionv3 import INCEPTIONV3_FEATURE_DIM, inception_v3
from .layers import init_params_
from .resnet2p1d import RESNET2P1D
from .resnet3d import RESNET3D, RESNET_I3D
from .s3d import S3D, S3D_FEATURE_DIM
from .slowfast import SLOWFAST_FEATURE_DIM, slowfast_r50
from .tiny import TINY3D_FEATURE_DIM, Tiny3D
from .wrappers import (CmcWrapper, ContrastWrapper, GraphWrapper, SimSiam, VideoModel,
                       VisualEncoder)

MEM_TYPES = ("moco", "bank", "simsiam")
CMC_MEM_TYPES = ("moco", "bank")


def _feature_dim(name: str) -> int:
    """512 for the basic-block ResNets (depth 10-34), 2048 for the rest."""
    return 512 if int(name.rsplit("_", 1)[-1]) < 50 else 2048


# name -> (ctor, feature_dim, default graph-aug points); the ResNets' aug
# points are the inputs of stages 2, 3 and 4 (JAX build.py:27-56)
BACKBONES_3D = {
    "S3D": (S3D, S3D_FEATURE_DIM, (5, 9, 14)),
    # S3D-G: S3D's topology with biased SepConv pairs (JAX build.py:30-31)
    "S3DG": (functools.partial(S3D, temporal_bias=True), S3D_FEATURE_DIM, (5, 9, 14)),
    # the reference's two I3D implementations are one network
    "I3D": (I3D, I3D_FEATURE_DIM, (5, 9, 14)),
    "InceptionI3d": (I3D, I3D_FEATURE_DIM, (5, 9, 14)),
    "i3d_res50_nonlocal": (i3d_res50_nonlocal, I3DNON_FEATURE_DIM, (2, 3, 4)),
    # the port's own: graph blocks on the Fast pathway's inputs of res3-res5
    "slowfast_r50": (slowfast_r50, SLOWFAST_FEATURE_DIM, (2, 3, 4)),
    **{name: (ctor, _feature_dim(name), (2, 3, 4))
       for name, ctor in {**RESNET2P1D, **RESNET3D, **RESNET_I3D}.items()},
    "tiny3d": (Tiny3D, TINY3D_FEATURE_DIM, (1,)),
}
BACKBONES_2D = {
    "bninception": (bninception, BNINCEPTION_FEATURE_DIM, ()),
    "inception_v3": (inception_v3, INCEPTIONV3_FEATURE_DIM, ()),
    "resnet18": (resnet2d.resnet18, 512, ()),
    "resnet34": (resnet2d.resnet34, 512, ()),
    "resnet50": (resnet2d.resnet50, 2048, ()),
    "resnet101": (resnet2d.resnet101, 2048, ()),
    "resnet152": (resnet2d.resnet152, 2048, ()),
}
BACKBONES = {"2D": BACKBONES_2D, "3D": BACKBONES_3D}


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


MODALITIES = ("RGB", "Flow", "RGBDiff")


def input_channels(cfg) -> int:
    """The backbone's input channels: 2 per stacked frame for Flow, 3 for
    RGB and RGBDiff (the latter after :func:`wrappers.rgb_diff`)."""
    modality = cfg.INPUT.MODALITY
    if modality not in MODALITIES:
        raise ValueError(f"INPUT.MODALITY must be one of {MODALITIES}, got {modality}")
    return (2 if modality == "Flow" else 3) * resolve_new_length(cfg)


def _not_ported(btype: str, name: str) -> str:
    """Why ``btype``/``name`` builds nothing."""
    other = "3D" if btype == "2D" else "2D"
    if name in BACKBONES[other]:
        hint = (f"{name} is a {other} backbone (the 2D ones: ROADMAP.md, Queue 1, item "
                f"6b): set MODEL.BACKBONE_TYPE {other}")
    else:
        hint = f"have {btype}: {sorted(BACKBONES.get(btype, {}))}"
    return f"backbone {btype}/{name} is not ported: {hint}"


def stem_s2d_mode(cfg, name: str) -> str:
    """``TPU.STEM_S2D`` as JAX reads it (``models/build.py:encoder_cfg_from``):
    "" (off, false, 0, none, ""), "full" (true, 1, full) or "spatial";
    anything else, or an S2D stem off S3D/S3DG, raises JAX's ValueError."""
    s2d = str(cfg.TPU.STEM_S2D).lower()
    if s2d in ("true", "1", "full"):
        s2d = "full"
    elif s2d in ("false", "0", "off", "none", ""):
        s2d = ""
    if s2d:
        if s2d not in ("full", "spatial"):
            raise ValueError(f"TPU.STEM_S2D must be off|full|spatial, "
                             f"got {cfg.TPU.STEM_S2D}")
        if name not in ("S3D", "S3DG"):
            raise ValueError(f"TPU.STEM_S2D only applies to S3D/S3DG, got {name}")
    return s2d


def resolve_remat(cfg, name: str):
    """``TPU.REMAT`` x ``TPU.REMAT_POLICY`` as JAX reads them
    (``models/build.py:_resolve_remat``): False when off, True for
    ``block``, "conv_saved" (S3D/S3DG only); anything else raises JAX's
    ValueError."""
    if not bool(cfg.TPU.REMAT):
        return False
    policy = str(cfg.TPU.REMAT_POLICY)
    if policy == "block":
        return True
    if policy == "conv_saved":
        if name not in ("S3D", "S3DG"):
            raise ValueError(f"TPU.REMAT_POLICY=conv_saved only applies to S3D/S3DG, "
                             f"got {name}")
        return "conv_saved"
    raise ValueError(f"TPU.REMAT_POLICY must be block|conv_saved, got {policy}")


def create_backbone(cfg, partial_bn: bool = False) -> Tuple[torch.nn.Module, int]:
    """The configured backbone (graph blocks with ``MODEL.AUG_FLAG`` on a 3D
    one, K5's backward with ``TPU.SEPCONV_FUSED`` on S3D, recompute units
    with ``TPU.REMAT`` on a 3D one, the space-to-depth stem with
    ``TPU.STEM_S2D`` on S3D/S3DG) and its feature dim; raises for what is
    not ported, and JAX's ValueErrors for the TPU layouts JAX refuses, in
    JAX's order (``TPU.STEM_S2D``, then ``TPU.SEPCONV_FUSED``, then
    ``TPU.REMAT``)."""
    name, btype = cfg.MODEL.BACKBONE, cfg.MODEL.BACKBONE_TYPE
    if name not in BACKBONES.get(btype, {}):
        raise NotImplementedError(_not_ported(btype, name))
    s2d = stem_s2d_mode(cfg, name)
    ctor, feat_dim, default_aug = BACKBONES[btype][name]
    aug = bool(cfg.MODEL.AUG_FLAG) and btype == "3D"
    extra = {"partial_bn": True} if partial_bn else {}
    if input_channels(cfg) != 3:
        extra["in_channels"] = input_channels(cfg)
    if bool(cfg.TPU.SEPCONV_FUSED):
        if name != "S3D":
            # S3DG's biased pairs and the other backbones' convs take the
            # standard backward, as in JAX build.py:153-157
            raise ValueError(f"TPU.SEPCONV_FUSED only applies to S3D, got {name}")
        extra["fused_sepconv"] = True
    remat = resolve_remat(cfg, name)
    if btype == "3D":
        extra["remat"] = remat
    if s2d:
        extra["stem_s2d"] = s2d
    backbone = ctor(
        aug_points=(tuple(cfg.GRAPH.AUG_POINTS) or default_aug) if aug else (),
        graph_cfg=graph_cfg_from(cfg) if aug else None,
        dtype=compute_dtype(cfg), **extra)
    return backbone, feat_dim


def _encoder_kw(cfg) -> Dict[str, Any]:
    return dict(dropout=float(cfg.MODEL.DROPOUT), backbone_type=cfg.MODEL.BACKBONE_TYPE,
                agg_fun=cfg.MODEL.POOLING_TYPE, modality=cfg.INPUT.MODALITY)


def is_cmc(cfg) -> bool:
    """CMC (two modalities): ``CROSS.MODALITY`` other than ``visual``."""
    return cfg.CROSS.MODALITY != "visual"


# CMC's second stack is initialised from its own generator, seeded this far
# from the first's
CMC_STACK_SEED = 1_000_003


def create_visual_model(cfg, seed: int = None) -> Tuple[torch.nn.Module, int]:
    """The SSL pretraining model, initialised on the CPU from
    ``MODEL.SEED`` (or ``seed``); returns (module, backbone feature dim).
    ``simsiam`` builds SimSiam's two-view model (hid_dim
    ``CROSS.FEAT_DIM``), ``moco`` and ``bank`` the encoder + projection
    head; under CMC (``CROSS.MODALITY`` other than ``visual``, moco or bank
    only, as in JAX) a ``CmcWrapper`` of two such stacks, each with its own
    backbone and graph blocks, ``model_1`` initialised as the visual model
    of the same seed and ``model_2`` from a generator of its own."""
    mem_type = cfg.CONTRAST.MEM_TYPE
    backbone, feat_dim = create_backbone(cfg)
    hid_dim = int(cfg.CROSS.FEAT_DIM)
    seed = int(cfg.MODEL.SEED if seed is None else seed)
    if is_cmc(cfg):
        if mem_type not in CMC_MEM_TYPES:
            raise ValueError(f"CROSS.MODALITY={cfg.CROSS.MODALITY!r} (CMC) supports "
                             f"moco/bank memories, not {mem_type!r}")
        stacks = []
        for i, b in enumerate((backbone, create_backbone(cfg)[0])):
            stack = GraphWrapper(ContrastWrapper(VisualEncoder(b, **_encoder_kw(cfg)),
                                                 feat_dim, hid_dim, cfg.CROSS.HEAD_TYPE))
            init_params_(stack, torch.Generator().manual_seed(seed + i * CMC_STACK_SEED))
            stacks.append(stack)
        return CmcWrapper(*stacks), feat_dim
    if mem_type not in MEM_TYPES:
        raise ValueError(f"Unknown CONTRAST.MEM_TYPE: {mem_type}")
    encoder = VisualEncoder(backbone, **_encoder_kw(cfg))
    if mem_type == "simsiam":
        model = GraphWrapper(SimSiam(encoder, feat_dim, hid_dim))
    else:
        model = GraphWrapper(ContrastWrapper(encoder, feat_dim, hid_dim,
                                             cfg.CROSS.HEAD_TYPE))
    init_params_(model, torch.Generator().manual_seed(seed))
    return model, feat_dim


def create_video_model(cfg, seed: int = None) -> Tuple[VideoModel, int]:
    """The downstream fine-tune / linear-probe classifier (JAX
    ``create_video_model``), initialised on the CPU from ``MODEL.SEED`` (or
    ``seed``): partial BN unless ``MODEL.NO_PARTIALBN``, ``MODEL.DROPOUT``
    on the features, ``DATASET.NUM_CLASS`` logits; returns (module,
    backbone feature dim)."""
    backbone, feat_dim = create_backbone(cfg, partial_bn=not bool(cfg.MODEL.NO_PARTIALBN))
    model = VideoModel(backbone, feat_dim, int(cfg.DATASET.NUM_CLASS), **_encoder_kw(cfg))
    gen = torch.Generator().manual_seed(int(cfg.MODEL.SEED if seed is None else seed))
    init_params_(model, gen)
    with torch.no_grad():
        torch.nn.init.normal_(model.new_fc.weight, 0.0, 0.001, generator=gen)
        model.new_fc.bias.zero_()
    return model, feat_dim
