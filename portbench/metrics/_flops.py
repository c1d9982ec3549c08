"""Model operations of one training step, counted with
``torch.utils.flop_counter.FlopCounterMode`` on the plain reference at the
cell's shapes on the ``meta`` device: the key pass (no gradient), the query
pass, the logits against the queue and the backward, with no recompute.  The
count depends on the configuration and the traffic alone, never on how the
program computes the step."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.models import build_model

from ._shapes import clip_shape, rows_per_rank


@functools.lru_cache(maxsize=8)
def _count(backbone: str, aug_points: tuple, feat_dim: int, queue: int, shape: tuple) -> int:
    with torch.device("meta"):
        model = build_model(backbone, aug_points, feat_dim)
        ema = build_model(backbone, aug_points, feat_dim)
        x1, x2 = torch.empty(shape), torch.empty(shape)
        bank = torch.empty((queue, feat_dim))
    model.train()
    ema.train()
    counter = FlopCounterMode(display=False)
    with counter:
        with torch.no_grad():
            k = ema(x2, 0)
        q = model(x1, 0)
        logits = torch.cat([(q * k).sum(-1, keepdim=True), q @ bank.t()], dim=1)
        torch.log_softmax(logits, dim=-1)[:, 0].mean().backward()
    return int(counter.get_total_flops())


def moco_step_flops(settings: dict, ranks: int = 1) -> int:
    """Operations of one MoCo step on this rank's rows."""
    return _count(settings["MODEL.BACKBONE"], tuple(settings["GRAPH.AUG_POINTS"]),
                  int(settings["CROSS.FEAT_DIM"]), int(settings["CONTRAST.NCE_K"]),
                  clip_shape(settings, rows_per_rank(settings, ranks)))
