"""The pretraining model of a configuration: backbone -> projection head,
under the wrapper names of the original code (``model.encoder.base_model.*``,
``model.proj_head.head.*``), plus the rule by which the benchmark draws its
weights."""

from __future__ import annotations

import importlib

import torch
from torch import nn

from .graph import TemporalGraphAug
from .nn import BatchNorm, Rounding, l2_normalize


def backbone_class(name: str):
    """``Backbone`` of ``backbones/<name>.py``, ``name`` the program's
    ``MODEL.BACKBONE``."""
    try:
        return importlib.import_module(f"{__package__}.backbones.{name}").Backbone
    except ModuleNotFoundError as e:
        raise ValueError(f"no reference for backbone {name!r}") from e


class VisualEncoder(nn.Module):
    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.base_model = backbone

    def forward(self, x, graph_seed: int):
        return self.base_model(x, graph_seed)


class ProjectHead(nn.Module):
    """Linear, ReLU, Linear, then L2 normalisation (float32 in the program
    too)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.head = nn.Sequential(nn.Linear(in_dim, in_dim), nn.ReLU(), nn.Linear(in_dim, out_dim))

    def forward(self, x):
        return l2_normalize(self.head(x))


class ContrastWrapper(nn.Module):
    def __init__(self, backbone: nn.Module, feat_dim: int):
        super().__init__()
        self.encoder = VisualEncoder(backbone)
        self.proj_head = ProjectHead(backbone.feature_dim, feat_dim)

    def forward(self, x, graph_seed: int):
        return self.proj_head(self.encoder(x, graph_seed))


class GraphWrapper(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x, graph_seed: int):
        return self.model(x, graph_seed)


def build_model(backbone: str, aug_points, feat_dim: int, rounding=None) -> GraphWrapper:
    """The model of ``backbone`` with graph blocks at ``aug_points``; with
    ``rounding="fp8"`` the control's products."""
    model = GraphWrapper(ContrastWrapper(backbone_class(backbone)(tuple(aug_points)), feat_dim))
    set_rounding(model, rounding)
    return model


def set_rounding(model: nn.Module, mode) -> None:
    for m in model.modules():
        if isinstance(getattr(m, "rounding", None), Rounding):
            m.rounding = Rounding(mode)


# the graph blocks' q/k embeddings are drawn at this share of the program's
# fan-in scale: at the full scale the similarities over D reach hundreds, the
# row softmax is one-hot, and the q/k gradients come from the clipped tails of
# the relaxed-Bernoulli sampler, where any rounding of the similarity decides
# them
QK_SCALE = 0.03


def weight_specs(model: nn.Module):
    """[(name, shape, kind)] of every parameter in name order; kind is
    ``normal`` (std 1/sqrt(fan_in): conv and linear weights), ``uniform``
    (+-1/sqrt(fan_in): the GCN's 1x1x1 convs), ``qk`` (the same times
    :data:`QK_SCALE`: the q/k embeddings), ``one`` (BN scales) or ``zero``
    (biases)."""
    graph = {id(p) for m in model.modules() if isinstance(m, TemporalGraphAug)
             for p in m.parameters()}
    qk = {id(m.g_q[0].weight) for m in model.modules() if isinstance(m, TemporalGraphAug)}
    qk |= {id(m.g_k[0].weight) for m in model.modules() if isinstance(m, TemporalGraphAug)}
    bn = {id(m.weight) for m in model.modules() if isinstance(m, BatchNorm)}
    specs = []
    for name, p in sorted(model.named_parameters()):
        if name.endswith("bias"):
            kind = "zero"
        elif id(p) in bn:
            kind = "one"
        elif id(p) in qk:
            kind = "qk"
        elif id(p) in graph:
            kind = "uniform"
        else:
            kind = "normal"
        specs.append((name, tuple(p.shape), kind))
    return specs


def make_weights(specs, seed: int, device, encoder: int = 0) -> dict:
    """The weights of ``specs`` from ``seed``, float32 on ``device``: two
    draws (one normal, one uniform) over all leaves, scaled per leaf by
    1/sqrt(fan_in) (and :data:`QK_SCALE`).  ``encoder`` 1 draws another
    set from the same seed (the MoCo EMA encoder's start)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2_654_435_761 + 17 + 6 * int(encoder)) & 0x7FFF_FFFF_FFFF_FFFF)
    draw = {"normal": "normal", "uniform": "uniform", "qk": "uniform"}
    numel = {k: sum(int(torch.Size(s).numel()) for _, s, kd in specs if draw.get(kd) == k)
             for k in ("normal", "uniform")}
    pools = {"normal": torch.randn(numel["normal"], generator=g, device=device),
             "uniform": torch.rand(numel["uniform"], generator=g, device=device) * 2.0 - 1.0}
    offset = {"normal": 0, "uniform": 0}
    scale = {"normal": 1.0, "uniform": 1.0, "qk": QK_SCALE}
    out = {}
    for name, shape, kind in specs:
        n = int(torch.Size(shape).numel())
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            src = draw[kind]
            chunk = pools[src][offset[src]:offset[src] + n].reshape(shape)
            out[name] = chunk * (scale[kind] * (n // shape[0]) ** -0.5)
            offset[src] += n
    return out


def make_queue(seed: int, k: int, dim: int, device) -> torch.Tensor:
    """The MoCo queue's first state: (K, dim) L2-normalised normal rows."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2_654_435_761 + 29) & 0x7FFF_FFFF_FFFF_FFFF)
    return l2_normalize(torch.randn((k, dim), generator=g, device=device))
