"""The shapes of one encoder pass at a cell's sizes, from a walk of the
plain reference model on the ``meta`` device (no memory, no arithmetic):
every 3D max pool's input and output, and each graph block's q/k (B, T, D)
and GCN input (B, T, H, W, C)."""

from __future__ import annotations

import functools

import torch

from portbench.reference.graph import TemporalGraphAug
from portbench.reference.models import build_model
from portbench.reference.nn import MaxPool3d


def clip_shape(settings: dict, rows: int) -> tuple:
    """(B, T, H, W, 3) of one view after the augmentation."""
    h, w = settings["INPUT.BASE_SIZE"]
    return (int(rows), int(settings["INPUT.VIDEO_LENGTH"]), int(h), int(w), 3)


def rows_per_rank(settings: dict, ranks: int = 1) -> int:
    return int(settings["DATALOADER.BATCH_SIZE"]) // int(ranks)


@functools.lru_cache(maxsize=8)
def _walk(backbone: str, aug_points: tuple, feat_dim: int, shape: tuple) -> dict:
    with torch.device("meta"):
        model = build_model(backbone, aug_points, feat_dim)
    pools = []
    for m in model.modules():
        if isinstance(m, MaxPool3d):
            m.register_forward_hook(
                lambda mod, inp, out: pools.append((tuple(inp[0].shape), tuple(out.shape))))
    model.train()
    with torch.no_grad():
        model(torch.empty(shape, device="meta"), 0)
    graphs = [m.last_shapes for m in model.modules() if isinstance(m, TemporalGraphAug)]
    return {"pools": pools, "graphs": graphs}


def pass_shapes(settings: dict, ranks: int = 1) -> dict:
    """{"pools": [(x NCDHW, y NCDHW)], "graphs": [((B, T, D), (B, T, H, W, C))]}
    of one pass over this rank's rows."""
    return _walk(settings["MODEL.BACKBONE"], tuple(settings["GRAPH.AUG_POINTS"]),
                 int(settings["CROSS.FEAT_DIM"]),
                 clip_shape(settings, rows_per_rank(settings, ranks)))
