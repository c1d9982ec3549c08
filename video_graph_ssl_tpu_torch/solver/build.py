"""Optimizer and LR schedule (counterpart of
``video_graph_ssl_tpu/solver/build.py``).

The JAX package expresses the reference's parameter groups as an optax
chain: weight decay per group, the bias gradient scaled by
``BIAS_LR_FACTOR``, then momentum.  With SGD the update is linear in the
gradient, so two ``torch.optim.SGD`` groups give the same steps: weights
with lr and ``WEIGHT_DECAY``, biases with lr * ``BIAS_LR_FACTOR`` and
``WEIGHT_DECAY_BIAS`` (``tests/test_torch_moco_step.py`` checks it against
the optax chain).  The per-step lr is written into each group as
``lr * group['lr_factor']``.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable, Dict

import torch
from torch import nn


def label_params(model: nn.Module) -> Dict[str, str]:
    """'bias' for every parameter whose name ends in ``bias`` (conv, linear
    and BN biases), 'weight' for the rest -- BN scales included, as the
    reference groups them with ``USE_TRICK: False``."""
    return {name: ("bias" if name.rsplit(".", 1)[-1] == "bias" else "weight")
            for name, _ in model.named_parameters()}


def make_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    if bool(cfg.SOLVER.USE_TRICK):
        raise NotImplementedError("SOLVER.USE_TRICK policies are not ported yet")
    if cfg.SOLVER.OPTIMIZER_NAME != "SGD":
        raise NotImplementedError(
            f"optimizer {cfg.SOLVER.OPTIMIZER_NAME} is not ported yet (SGD is)")
    labels = label_params(model)
    params = dict(model.named_parameters())
    groups = []
    for label, wd, factor in (
            ("weight", float(cfg.SOLVER.WEIGHT_DECAY), 1.0),
            ("bias", float(cfg.SOLVER.WEIGHT_DECAY_BIAS),
             float(cfg.SOLVER.BIAS_LR_FACTOR))):
        ps = [params[n] for n, lab in labels.items() if lab == label]
        if ps:
            groups.append(dict(params=ps, weight_decay=wd, lr_factor=factor,
                               lr=float(cfg.SOLVER.BASE_LR) * factor))
    return torch.optim.SGD(groups, lr=float(cfg.SOLVER.BASE_LR),
                           momentum=float(cfg.SOLVER.MOMENTUM),
                           nesterov=bool(cfg.SOLVER.NESTEROV))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_factor"]


def grad_clip_norm(cfg):
    """``SOLVER.CLIP_GRADIENT`` as a float, or None when off."""
    clip = cfg.SOLVER.CLIP_GRADIENT
    if isinstance(clip, (int, float)) and not isinstance(clip, bool) and clip:
        return float(clip)
    return None


def make_lr_scheduler(cfg) -> Callable[[int], float]:
    """epoch -> lr, WarmupMultiStepLR semantics (the JAX package's
    ``make_lr_scheduler``)."""
    base_lr = float(cfg.SOLVER.BASE_LR)
    mode = cfg.SOLVER.LR_SCHEDULER
    milestones = list(cfg.SOLVER.STEPS)
    gamma = float(cfg.SOLVER.GAMMA)
    warmup_factor = float(cfg.SOLVER.WARMUP_FACTOR)
    warmup_iters = int(cfg.SOLVER.WARMUP_ITERS)
    warmup_method = cfg.SOLVER.WARMUP_METHOD
    max_epochs = int(cfg.SOLVER.MAX_EPOCHS)
    lr_step = int(cfg.SOLVER.LR_STEP)

    def lr_at(epoch: int) -> float:
        wf = 1.0
        if epoch < warmup_iters:
            if warmup_method == "constant":
                wf = warmup_factor
            elif warmup_method == "linear":
                alpha = float(epoch) / warmup_iters
                wf = warmup_factor * (1 - alpha) + alpha
            else:
                raise ValueError(f"Unknown warmup method: {warmup_method}")
        if mode == "step":
            if milestones:
                factor = gamma ** bisect_right(milestones, epoch)
            else:
                factor = gamma ** (epoch // lr_step)
        elif mode == "poly":
            factor = (1.0 - float(epoch) / max_epochs) ** 0.9
        elif mode == "cos":
            factor = 0.5 * (1.0 + math.cos(float(epoch) / max_epochs * math.pi))
        else:
            raise NotImplementedError(f"Unsupported scheduler: {mode}")
        return base_lr * wf * factor

    return lr_at
