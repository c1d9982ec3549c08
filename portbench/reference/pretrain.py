"""The first steps of GCA MoCo pretraining in plain float32, from the
benchmark's inputs: the readings that the check compares.

A step (the original code's MoCo with GCA, as the measured program runs it):
the EMA encoder starts from weights of its own (:data:`KEY_ENCODER`), so each
step moves it by (1 - alpha)(query - EMA); the two-view augmentation from the step's augmentation seed, the key pass of
the EMA encoder on view 2 (BN in train mode, no gradient), the query pass on
view 1, InfoNCE over [positive; queue] / T, SGD with momentum, weight decay
and the bias lr factor, the keys into the queue, then the EMA of the
parameters.  Both passes of a step share the step's graph seed.
"""

from __future__ import annotations

import copy
from bisect import bisect_right
from typing import Optional

import torch

from .augment import augment
from .models import build_model, make_queue, make_weights, weight_specs
from .nn import Rounding

MASK63 = 0x7FFF_FFFF_FFFF_FFFF
GRAPH_STREAM, AUGMENT_STREAM = 1, 2
# ``make_weights``'s draw of the EMA encoder's starting weights
KEY_ENCODER = 1


def step_seed(base: int, step: int, stream: int) -> int:
    """The seed of one random stream of a step; ``base`` is MODEL.SEED + 2."""
    return ((int(base) * 1_000_003 + int(step)) * 31 + int(stream)) & MASK63


def epoch_lr(cfg: dict, epoch: int) -> float:
    """WarmupMultiStepLR at ``epoch`` (linear warm-up, milestones)."""
    if cfg["SOLVER.LR_SCHEDULER"] != "step" or cfg["SOLVER.WARMUP_METHOD"] != "linear":
        raise ValueError("the reference follows the step schedule with linear warm-up only")
    base = float(cfg["SOLVER.BASE_LR"])
    warm = int(cfg["SOLVER.WARMUP_ITERS"])
    wf = 1.0
    if epoch < warm:
        a = float(epoch) / warm
        wf = float(cfg["SOLVER.WARMUP_FACTOR"]) * (1 - a) + a
    return base * wf * float(cfg["SOLVER.GAMMA"]) ** bisect_right(list(cfg["SOLVER.STEPS"]),
                                                                  epoch)


class Sgd:
    """SGD with momentum as ``torch.optim.SGD`` computes it, with per-leaf
    weight decay and lr factor (biases: ``WEIGHT_DECAY_BIAS`` and
    ``BIAS_LR_FACTOR``; every other leaf, BN scales included: ``WEIGHT_DECAY``
    and 1)."""

    def __init__(self, named_params, cfg: dict):
        self.params = dict(named_params)
        self.m = float(cfg["SOLVER.MOMENTUM"])
        bias = (float(cfg["SOLVER.WEIGHT_DECAY_BIAS"]), float(cfg["SOLVER.BIAS_LR_FACTOR"]))
        self.rule = {n: bias if n.endswith("bias") else (float(cfg["SOLVER.WEIGHT_DECAY"]), 1.0)
                     for n in self.params}
        self.buf = {}

    @torch.no_grad()
    def step(self, lr: float) -> None:
        for n, p in self.params.items():
            if p.grad is None:
                continue
            wd, factor = self.rule[n]
            d = p.grad + wd * p if wd else p.grad.clone()
            self.buf[n] = d if n not in self.buf else self.buf[n].mul_(self.m).add_(d)
            p.add_(self.buf[n], alpha=-lr * factor)


def bn_running_vars(model) -> dict:
    """Module path -> running variance (float64, on the host) of every BN."""
    suffix = ".running_var"
    return {n[:-len(suffix)]: b.detach().to("cpu", torch.float64, copy=True)
            for n, b in model.named_buffers() if n.endswith(suffix)}


def leaf_norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def run_moco(cfg: dict, seed: int, pool: torch.Tensor, steps: int = 3,
             rounding: Optional[str] = None, keep_rows: Optional[int] = None,
             dtype: torch.dtype = torch.float32) -> dict:
    """``steps`` MoCo steps of the cell's settings ``cfg`` (the dotted keys
    of its configuration and traffic files) from ``seed``'s weights and
    queue, on the raw uint8 batches ``pool`` (P, B, 2, T, H, W, 3), batch s taking pool[s % P].

    ``rounding="fp8"`` is the control (``"bf16"`` the same in bfloat16); ``keep_rows`` a fault that drops all
    but the first rows of each augmented batch, so the loss is the mean over
    those.  ``dtype`` float64 serves tests on the CPU.  Returns the readings:
    ``loss`` per step, ``grad`` (each leaf's norm of the first gradient),
    ``delta`` (each leaf's norm of its change over the steps), ``ema_delta``
    (the same in the EMA encoder), ``ema_apart`` (each leaf's norm of the
    difference between the two encoders' starting weights), ``bn`` (every
    BN's running variance in both encoders after the first step, by module
    path) and ``bn_momentum``, ``keys`` (the rows the steps put into the
    queue)."""
    device = pool.device
    model = build_model(cfg["MODEL.BACKBONE"], cfg["GRAPH.AUG_POINTS"],
                        int(cfg["CROSS.FEAT_DIM"]), rounding).to(device=device, dtype=dtype)
    specs = weight_specs(model)
    w0 = {n: w.to(dtype) for n, w in make_weights(specs, seed, device).items()}
    k0 = {n: w.to(dtype) for n, w in make_weights(specs, seed, device, KEY_ENCODER).items()}
    ema = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w0[n])
        for n, p in ema.named_parameters():
            p.copy_(k0[n])
            p.requires_grad_(False)
    queue = make_queue(seed, int(cfg["CONTRAST.NCE_K"]), int(cfg["CROSS.FEAT_DIM"]),
                       device).to(dtype)
    ptr, K = 0, queue.shape[0]
    sgd = Sgd(model.named_parameters(), cfg)
    lr = epoch_lr(cfg, 0)
    out_hw = tuple(cfg["INPUT.BASE_SIZE"])
    flip_p = 0.5 if cfg["INPUT.FLIP"] else 0.0
    temperature, alpha = float(cfg["CONTRAST.NCE_T"]), float(cfg["CONTRAST.ALPHA"])
    base = int(seed) + 2
    losses, grad, keys = [], None, []
    model.train()
    ema.train()
    for s in range(steps):
        clips = augment(pool[s % pool.shape[0]], step_seed(base, s, AUGMENT_STREAM), out_hw,
                        cfg["INPUT.MEAN"], cfg["INPUT.STD"], flip_p).to(dtype)
        if keep_rows is not None:
            clips = clips[:keep_rows]
        clips = Rounding(rounding)(clips)
        gseed = step_seed(base, s, GRAPH_STREAM)
        with torch.no_grad():
            k = ema(clips[:, 1], gseed)
        q = model(clips[:, 0], gseed)
        logits = torch.cat([(q * k).sum(-1, keepdim=True), q @ queue.t()], dim=1) / temperature
        loss = -torch.log_softmax(logits, dim=-1)[:, 0].mean()
        for p in model.parameters():
            p.grad = None
        loss.backward()
        if s == 0:
            grad = leaf_norms({n: p.grad for n, p in model.named_parameters()})
            bn = {"model": bn_running_vars(model), "ema": bn_running_vars(ema)}
        sgd.step(lr)
        with torch.no_grad():
            idx = (ptr + torch.arange(k.shape[0], device=device)) % K
            queue.index_copy_(0, idx, k)
            ptr = (ptr + k.shape[0]) % K
            for e, p in zip(ema.parameters(), model.parameters()):
                e.mul_(alpha).add_(p, alpha=1.0 - alpha)
        losses.append(float(loss.detach()))
        keys.append(k.detach().float().cpu())
        del clips, q, k, logits, loss
    with torch.no_grad():
        delta = leaf_norms({n: p - w0[n] for n, p in model.named_parameters()})
        ema_delta = leaf_norms({n: p - k0[n] for n, p in ema.named_parameters()})
        apart = leaf_norms({n: k0[n] - w0[n] for n in w0})
    return {"loss": losses, "grad": grad, "delta": delta, "ema_delta": ema_delta,
            "ema_apart": apart, "keys": torch.cat(keys), "bn": bn,
            "bn_momentum": next(m.momentum for m in model.modules() if hasattr(m, "running_var"))}
