"""Optimizer and LR schedules (counterpart of
``video_graph_ssl_tpu/solver/build.py``).

The JAX package builds one optax chain per config: ``clip_by_global_norm``
(``SOLVER.CLIP_GRADIENT``) at its head, then per parameter group a weight
decay and a gradient scale (the bias factor ``BIAS_LR_FACTOR``, or under
``SOLVER.USE_TRICK`` the TSN policies' ``decay_mult`` and ``lr_mult``),
then the optimizer's own transform, then ``scale(-lr)``.  The port keeps
that chain term by term:

* SGD: ``torch.optim.SGD`` with one group per label.  Its update is linear
  in the gradient, so a group's gradient scale is folded into its ``lr``
  (``lr_factor``), as ``tests/test_torch_moco_step.py`` holds against
  optax.
* Adam, AdamW, LARS: :class:`ChainOptimizer`, the optax transforms in
  order, with each group's gradient scale applied where JAX applies it
  (before the optimizer's transform, where a scale no longer cancels).
  JAX's "AdamW" is its Adam: both add the weight decay to the gradient
  before ``scale_by_adam`` (optax's defaults: b1 0.9, b2 0.999, eps 1e-8,
  eps_root 0, bias correction by the step count), which
  ``torch.optim.AdamW``'s decoupled decay is not.  LARS is
  ``scale_by_trust_ratio`` per parameter tensor (ratio |p| / |u|, 1 where
  either is 0), then ``trace(SOLVER.MOMENTUM)`` without Nesterov.

The per-step lr is written into each group as ``lr * group['lr_factor']``.
``trainable`` (the linear probe's ``new_fc``) chooses the parameters the
optimizer holds; the others take no step and keep no state, which is what
the JAX package's ``set_to_zero`` mask over the final updates gives them.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..models.layers import BatchNorm

OPTIMIZERS = ("SGD", "Adam", "AdamW", "LARS")
# optax.scale_by_adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0

# the TSN policy table (JAX ``_TRICK_POLICIES``, reference
# visual_wrappers.py:196-211); Flow boosts the first conv's lr
TRICK_POLICIES = {
    "first_conv_weight": {"lr_mult_rgb": 1.0, "lr_mult_flow": 5.0, "decay_mult": 1.0},
    "first_conv_bias": {"lr_mult_rgb": 2.0, "lr_mult_flow": 10.0, "decay_mult": 0.0},
    "normal_weight": {"lr_mult_rgb": 1.0, "lr_mult_flow": 1.0, "decay_mult": 1.0},
    "normal_bias": {"lr_mult_rgb": 2.0, "lr_mult_flow": 2.0, "decay_mult": 0.0},
    "bn": {"lr_mult_rgb": 1.0, "lr_mult_flow": 1.0, "decay_mult": 0.0},
    "fc_weight": {"lr_mult_rgb": 5.0, "lr_mult_flow": 5.0, "decay_mult": 1.0},
    "fc_bias": {"lr_mult_rgb": 10.0, "lr_mult_flow": 10.0, "decay_mult": 0.0},
}


def label_params(model: nn.Module) -> Dict[str, str]:
    """'bias' for every parameter whose name ends in ``bias`` (conv, linear
    and BN biases), 'weight' for the rest -- BN scales included, as the
    reference groups them with ``USE_TRICK: False``."""
    return {name: ("bias" if name.rsplit(".", 1)[-1] == "bias" else "weight")
            for name, _ in model.named_parameters()}


def first_conv(model: nn.Module) -> Optional[nn.Module]:
    """The network's first conv, found as JAX finds it: the module whose
    weight has rank >= 4 and 2 or 3 input channels (a Flow stem of one
    stack, or an RGB one).  A Dense layer (JAX's graph-block embeddings,
    1x1x1 convs here) has no such shape at the widths the port builds."""
    for m in model.modules():
        w = getattr(m, "weight", None)
        if (isinstance(m, (nn.Conv2d, nn.Conv3d)) and isinstance(w, nn.Parameter)
                and w.dim() >= 4 and w.shape[1] in (2, 3)):
            return m
    return None


def label_params_trick(model: nn.Module) -> Dict[str, str]:
    """The TSN 'trick' policy labels of JAX ``label_params_trick``: the
    first conv's weight and bias their own groups, every BN's scale and
    bias 'bn', the classifier's (``fc``/``new_fc``, and the head layers JAX
    names ``fc``: ``heads.jax_fc``) weight and bias their own, the rest
    'normal_weight' or 'normal_bias'."""
    stem = first_conv(model)
    owner = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            owner[f"{mname}.{pname}" if mname else pname] = m
    labels = {}
    for name, _ in model.named_parameters():
        comps = name.split(".")
        bias = comps[-1] == "bias"
        m = owner[name]
        if stem is not None and m is stem:
            labels[name] = "first_conv_bias" if bias else "first_conv_weight"
        elif isinstance(m, (BatchNorm, nn.modules.batchnorm._BatchNorm)):
            labels[name] = "bn"
        elif getattr(m, "jax_fc", False) or any(c in ("fc", "new_fc") for c in comps[:-1]):
            labels[name] = "fc_bias" if bias else "fc_weight"
        else:
            labels[name] = "normal_bias" if bias else "normal_weight"
    return labels


def group_rules(cfg, model: nn.Module) -> Dict[str, tuple]:
    """label -> (weight decay, gradient scale), and the labels of
    ``model``'s parameters: (rules, labels)."""
    wd = float(cfg.SOLVER.WEIGHT_DECAY)
    if bool(cfg.SOLVER.USE_TRICK):
        key = "lr_mult_flow" if cfg.INPUT.MODALITY == "Flow" else "lr_mult_rgb"
        rules = {g: (wd * pol["decay_mult"], pol[key]) for g, pol in TRICK_POLICIES.items()}
        return rules, label_params_trick(model)
    rules = {"weight": (wd, 1.0),
             "bias": (float(cfg.SOLVER.WEIGHT_DECAY_BIAS), float(cfg.SOLVER.BIAS_LR_FACTOR))}
    return rules, label_params(model)


class ChainOptimizer(torch.optim.Optimizer):
    """The optax chain of the JAX package for Adam, AdamW and LARS: per
    group ``weight_decay`` (added to the gradient) and ``grad_scale``, then
    ``scale_by_adam`` or ``scale_by_trust_ratio`` + ``trace(momentum)``,
    then ``-lr``, each term in JAX's order and in fp32.  The step count of
    the Adam bias correction is the chain's (every step counts, as optax's
    ``count``)."""

    def __init__(self, groups, name: str, momentum: float = 0.9):
        if name not in ("Adam", "AdamW", "LARS"):
            raise ValueError(f"ChainOptimizer: {name}")
        super().__init__(groups, dict(lr=0.0, weight_decay=0.0, grad_scale=1.0,
                                      lr_factor=1.0))
        self.name = name
        self.momentum = float(momentum)
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        self.count += 1
        n = self.count
        # optax.tree.bias_correction: 1 - decay ** count in fp32
        c1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.int32(n))
        c2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.int32(n))
        for group in self.param_groups:
            wd, scale, lr = group["weight_decay"], group["grad_scale"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad
                if wd:
                    u = u + wd * p
                if scale != 1.0:
                    u = u * scale
                st = self.state[p]
                if self.name == "LARS":
                    pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                    ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
                    u = u * ratio
                    if "trace" in st:
                        u = u + self.momentum * st["trace"]
                    st["trace"] = u
                else:
                    if "mu" not in st:
                        st["mu"], st["nu"] = torch.zeros_like(p), torch.zeros_like(p)
                    st["mu"] = (1.0 - ADAM_B1) * u + ADAM_B1 * st["mu"]
                    st["nu"] = (1.0 - ADAM_B2) * u.square() + ADAM_B2 * st["nu"]
                    u = (st["mu"] / c1) / (torch.sqrt(st["nu"] / c2 + ADAM_EPS_ROOT) + ADAM_EPS)
                p.add_(u * (-lr))

    def state_dict(self):
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count", 0))
        super().load_state_dict(state_dict)


def make_optimizer(cfg, model: nn.Module,
                   trainable: Optional[Callable[[str], bool]] = None) -> torch.optim.Optimizer:
    """``SOLVER.OPTIMIZER_NAME`` (SGD, Adam, AdamW, LARS) over ``model``'s
    parameters, or over those whose names ``trainable`` accepts, one group
    per label of ``SOLVER.USE_TRICK``'s grouping."""
    name = cfg.SOLVER.OPTIMIZER_NAME
    if name not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer: {name}")
    rules, labels = group_rules(cfg, model)
    params = dict(model.named_parameters())
    groups = []
    for label, (wd, scale) in rules.items():
        ps = [params[n] for n, lab in labels.items()
              if lab == label and (trainable is None or trainable(n))]
        if not ps:
            continue
        if name == "SGD":
            groups.append(dict(params=ps, weight_decay=wd, lr_factor=scale,
                               lr=float(cfg.SOLVER.BASE_LR) * scale, label=label))
        else:
            groups.append(dict(params=ps, weight_decay=wd, grad_scale=scale, lr_factor=1.0,
                               lr=float(cfg.SOLVER.BASE_LR), label=label))
    if name == "SGD":
        return torch.optim.SGD(groups, lr=float(cfg.SOLVER.BASE_LR),
                               momentum=float(cfg.SOLVER.MOMENTUM),
                               nesterov=bool(cfg.SOLVER.NESTEROV))
    return ChainOptimizer(groups, name, float(cfg.SOLVER.MOMENTUM))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_factor"]


def grad_clip_norm(cfg):
    """``SOLVER.CLIP_GRADIENT`` as a float, or None when off (JAX
    ``make_optimizer``: any non-zero number, ``True`` counting as 1)."""
    clip = cfg.SOLVER.CLIP_GRADIENT
    if isinstance(clip, (int, float)) and clip:
        return float(clip)
    return None


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm`` on the gradients of ``params`` in
    place: with g the global L2 norm (fp32), each gradient t becomes
    ``t / g * max_norm`` unless ``g < max_norm``.  Decided on the device
    (no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


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


def make_iter_lr_scheduler(cfg, iters_per_epoch: int) -> Callable[[int], float]:
    """iteration -> lr (JAX ``make_iter_lr_scheduler``, the reference's
    ``lr_helper.py`` ``LR_Scheduler``): cos, poly or step decay over all
    iterations with an iteration-granular linear warmup."""
    base_lr = float(cfg.SOLVER.BASE_LR)
    mode = cfg.SOLVER.LR_SCHEDULER
    total_iters = int(cfg.SOLVER.MAX_EPOCHS) * int(iters_per_epoch)
    warmup_iters = int(cfg.SOLVER.WARMUP_ITERS) * int(iters_per_epoch)
    lr_step = int(cfg.SOLVER.LR_STEP)
    gamma = float(cfg.SOLVER.GAMMA)

    def lr_at(it: int) -> float:
        if warmup_iters and it < warmup_iters:
            return base_lr * (it + 1) / warmup_iters
        if mode == "cos":
            return 0.5 * base_lr * (1.0 + math.cos(math.pi * it / total_iters))
        if mode == "poly":
            return base_lr * (1.0 - float(it) / total_iters) ** 0.9
        if mode == "step":
            return base_lr * gamma ** (it // (lr_step * iters_per_epoch))
        raise NotImplementedError(f"Unsupported scheduler: {mode}")

    return lr_at


# --------------------------------------------------------------------------- #
# lr spaces (JAX ``build_lr_spaces``; reference lib/solver/lr_helper.py:77-206)

def _log_space(epochs: int, start_lr: float = 0.03, end_lr: float = 5e-4, **_):
    return np.logspace(math.log10(start_lr), math.log10(end_lr), epochs)


def _step_space(epochs: int, start_lr: float = 0.01, end_lr: float = None,
                step: int = 10, mult: float = 0.1, **_):
    """With ``end_lr`` the start lr or the multiplier is solved for."""
    if end_lr is not None:
        if start_lr is None:
            start_lr = end_lr / (mult ** (epochs // step))
        else:
            mult = math.pow(end_lr / start_lr, 1.0 / (epochs // step))
    return start_lr * (mult ** (np.arange(epochs) // step))


def _multi_step_space(epochs: int, start_lr: float = 0.01, end_lr: float = None,
                      steps=(10, 20, 30, 40), mult: float = 0.5, **_):
    steps = list(steps)
    if end_lr is not None:
        if start_lr is None:
            start_lr = end_lr / (mult ** len(steps))
        else:
            mult = math.pow(end_lr / start_lr, 1.0 / len(steps))
    lr = np.empty(epochs, np.float64)
    lr[0] = start_lr
    for i in range(1, epochs):
        lr[i] = lr[i - 1] * (mult if i in steps else 1.0)
    return lr


def _linear_space(epochs: int, start_lr: float = 0.01, end_lr: float = 0.005, **_):
    return np.linspace(start_lr, end_lr, epochs)


def _cos_space(epochs: int, start_lr: float = 0.01, end_lr: float = 0.005, **_):
    idx = np.arange(epochs, dtype=np.float64)
    return end_lr + (start_lr - end_lr) * (1.0 + np.cos(idx * math.pi / epochs)) * 0.5


LR_SPACES = {"log": _log_space, "step": _step_space, "multi-step": _multi_step_space,
             "linear": _linear_space, "cos": _cos_space}


def build_lr_spaces(spec: dict, epochs: int = 50) -> np.ndarray:
    """Epoch-indexed lr array: a named space (``spec['type']``, default
    'log', with its keyword arguments), optionally prefixed by a warmup
    space that takes ``spec['warmup']['epoch']`` of the epochs."""
    spec = dict(spec)
    if "warmup" in spec:
        wspec = dict(spec.pop("warmup"))
        wepochs = int(wspec.pop("epoch"))
        return np.concatenate([build_lr_spaces(wspec, wepochs),
                               build_lr_spaces(spec, epochs - wepochs)])
    kind = spec.pop("type", "log")
    if kind not in LR_SPACES:
        raise ValueError(f'Unknown type of LR Scheduler "{kind}"')
    return np.asarray(LR_SPACES[kind](epochs, **spec), np.float64)
