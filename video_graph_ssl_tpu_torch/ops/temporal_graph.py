"""Temporal-graph augmentation (the GCA core), counterpart of
``video_graph_ssl_tpu/ops/temporal_graph.py``.

Public layout is the JAX package's ``(B, T, H, W, C)``.  On CUDA tensors
the block always runs the two hand-written kernels: the adjacency
(``ops/graph_kernel.py``, K1) and the GCN propagation
(``ops/gcn_propagate.py``, K2); on CPU tensors their plain versions.  The
JAX flags ``GRAPH.USE_PALLAS`` / ``GRAPH.PROPAGATE_PALLAS`` are TPU choices
and are not read.

Module names follow the reference (``g_q``/``g_k`` Sequentials with the
1x1x1 conv, optional BN and the (1,2,2) pool; ``gcns.{i}.conv``), so the
JAX package's ``export_graph_aug_to_torch`` names load strictly.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .gcn_propagate import gcn_propagate
from .graph_kernel import Rows, global_rows, graph_adjacency, relaxed_bernoulli


# --------------------------------------------------------------------------- #
# Static graph structure (numpy; copied from the JAX package)
# --------------------------------------------------------------------------- #
def temporal_hop_matrix(tem_len: int, max_hop: int = 1) -> np.ndarray:
    """Hop distance over the frame chain graph (self-links + (i, i+1)
    edges); +inf beyond ``max_hop``."""
    n = tem_len
    adj = np.zeros((n, n), dtype=np.float64)
    idx = np.arange(n)
    adj[idx, idx] = 1.0
    adj[idx[:-1], idx[:-1] + 1] = 1.0
    adj[idx[:-1] + 1, idx[:-1]] = 1.0

    hop_dis = np.full((n, n), np.inf)
    power = np.eye(n)
    reach = []
    for _ in range(max_hop + 1):
        reach.append(power > 0)
        power = power @ adj
    for d in range(max_hop, -1, -1):
        hop_dis[reach[d]] = d
    return hop_dis


def hop_theta(hop: float, alpha: float) -> float:
    """theta(h) = exp(-h) / (1 + exp(-h)^2) + alpha."""
    e = math.exp(-hop)
    return e / (1.0 + e * e) + alpha


def hop_weight_matrix(tem_len: int, max_hop: int, alpha: float) -> np.ndarray:
    """(T, T) weights: theta(hop) within ``max_hop``, 0 beyond."""
    hops = temporal_hop_matrix(tem_len, max_hop)
    w = np.zeros((tem_len, tem_len), dtype=np.float32)
    for d in range(max_hop + 1):
        w[hops == d] = hop_theta(float(d), alpha)
    return w


@functools.lru_cache(maxsize=64)
def _cached_theta(tem_len: int, max_hop: int, alpha: float, device: str) -> torch.Tensor:
    return torch.from_numpy(hop_weight_matrix(tem_len, max_hop, alpha)).to(device)


def _theta(tem_len: int, max_hop: int, alpha: float, device: str) -> torch.Tensor:
    """The (T, T) hop weights on ``device``, made once per process; under
    ``torch.export`` a new tensor, which becomes a constant of the graph (a
    tensor made while tracing is not one the cache may hand out later)."""
    fn = _cached_theta.__wrapped__ if torch.compiler.is_exporting() else _cached_theta
    return fn(tem_len, max_hop, alpha, device)


# --------------------------------------------------------------------------- #
# Samplers
# --------------------------------------------------------------------------- #
def relaxed_bernoulli_sample(probs: torch.Tensor, u: torch.Tensor,
                             temperature: float, eps: float = 1e-6) -> torch.Tensor:
    """Reparameterised RelaxedBernoulli draw from the uniform noise ``u``
    (drawn by the caller in U(eps, 1 - eps)):
    ``sigmoid((logit(clip(p)) + logit(u)) / tau)``."""
    return relaxed_bernoulli(probs.float(), u, temperature, eps).to(probs.dtype)


def gaussian_perturb_sample(adj: torch.Tensor, noise: torch.Tensor,
                            alpha: float) -> torch.Tensor:
    """``adj * (noise * alpha + 1)`` with standard-normal ``noise``."""
    return adj * (noise.float() * alpha + 1.0).to(adj.dtype)


def stage_seed(seed: int, idx: int) -> int:
    """Per-block graph seed from a step seed and the block's stage index."""
    return (int(seed) * 1_000_003 + 7919 * (int(idx) + 1)) & 0x7FFF_FFFF_FFFF_FFFF


# --------------------------------------------------------------------------- #
# Modules
# --------------------------------------------------------------------------- #
def _pointwise(cin: int, cout: int, bias: bool) -> nn.Conv3d:
    """1x1x1 conv (reference shape); ``models.layers.init_params_`` gives
    it the fan-in uniform init of the JAX block."""
    return nn.Conv3d(cin, cout, 1, bias=bias)


def _linear_cl(x: torch.Tensor, conv: nn.Conv3d, dtype) -> torch.Tensor:
    """A 1x1x1 conv on a channels-last (..., C) tensor: a Linear over C."""
    w = conv.weight.reshape(conv.weight.shape[0], -1).to(dtype)
    b = conv.bias.to(dtype) if conv.bias is not None else None
    return F.linear(x.to(dtype), w, b)


class GCN(nn.Module):
    """support = conv(x); out[b,i] = sum_j adj[b,i,j] support[b,j] (+ skip)."""

    def __init__(self, cin: int, cout: int, use_bias: bool = False,
                 skip: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = _pointwise(cin, cout, use_bias)
        self.skip = skip
        self.dtype = dtype

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        support = _linear_cl(x, self.conv, self.dtype)
        out = gcn_propagate(adj, support)
        if self.skip:
            out = out + support
        return out


class TemporalGraphAug(nn.Module):
    """The GCA graph-augmentation block: q/k embeddings, similarity
    adjacency, hop reweighting, stochastic sampling, stacked GCNs."""

    def __init__(self, in_channels: int, inter_channels: Optional[int] = None,
                 sub_sample: bool = True, use_bias: bool = False,
                 bn_layer: bool = False, max_pool: bool = True,
                 alpha: float = 0.5, num_gcn_layers: int = 1,
                 temperature: float = 1.0, max_hop: int = 3,
                 sampler: str = "relaxed_bernoulli", mask_frame: bool = False,
                 nei_size: int = 0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if sampler not in ("relaxed_bernoulli", "relaxed_bernoulli_sample",
                           "gaussian", "none"):
            raise ValueError(f"unknown graph sampler: {sampler}")
        inter = inter_channels or max(in_channels // 2, 1)
        self.alpha, self.temperature, self.max_hop = alpha, temperature, max_hop
        self.sampler, self.dtype = sampler, dtype
        self.nei_size = int(nei_size) if mask_frame else 0
        self.g_q = self._embed(in_channels, inter, use_bias, bn_layer,
                               sub_sample, max_pool)
        self.g_k = self._embed(in_channels, inter, use_bias, bn_layer,
                               sub_sample, max_pool)
        chans = [in_channels] if num_gcn_layers == 1 else (
            [inter] * (num_gcn_layers - 1) + [in_channels])
        cins = [in_channels] + chans[:-1]
        self.gcns = nn.ModuleList(
            GCN(ci, co, use_bias=use_bias, dtype=dtype)
            for ci, co in zip(cins, chans))

    @staticmethod
    def _embed(cin, inter, use_bias, bn_layer, sub_sample, max_pool) -> nn.Module:
        """Reference nesting: conv | Sequential(conv, bn), then
        Sequential(that, pool) when sub-sampling."""
        from ..models.layers import BatchNorm

        m: nn.Module = _pointwise(cin, inter, use_bias)
        if bn_layer:
            m = nn.Sequential(m, BatchNorm(inter, momentum=0.9, eps=1e-5,
                                           dtype=torch.float32))
        if sub_sample:
            pool = (nn.MaxPool2d(2, 2) if max_pool else nn.AvgPool2d(2, 2))
            m = nn.Sequential(m, pool)
        return m

    def _embed_apply(self, m: nn.Module, x: torch.Tensor) -> torch.Tensor:
        pool = None
        if isinstance(m, nn.Sequential) and isinstance(
                m[-1], (nn.MaxPool2d, nn.AvgPool2d)):
            m, pool = m[0], m[-1]
        bn = None
        if isinstance(m, nn.Sequential):
            m, bn = m[0], m[1]
        h = _linear_cl(x, m, self.dtype)                     # (b,t,h,w,c')
        if bn is not None:
            h = bn(h, channel_dim=-1).to(self.dtype)
        if pool is not None:
            b, t, hh, ww, c = h.shape
            h2 = pool(h.reshape(b * t, hh, ww, c).permute(0, 3, 1, 2))
            h = h2.permute(0, 2, 3, 1).reshape(b, t, h2.shape[2], h2.shape[3], c)
        return h

    def forward(self, x: torch.Tensor, seed: int = 0,
                noise: Optional[torch.Tensor] = None,
                rows: Rows = None) -> torch.Tensor:
        """``x`` (B, T, H, W, C) -> same shape in the compute dtype.

        ``seed`` keys the graph noise; ``noise`` (B, T, T), when given,
        replaces the draw: U(eps, 1-eps) for the relaxed-Bernoulli samplers,
        N(0, 1) for ``gaussian``.  ``rows`` (row0, global B): ``x`` holds
        rows ``[row0, row0 + B)`` of a global batch, and the draws are
        those rows of the global batch's."""
        b, t = x.shape[:2]
        q = self._embed_apply(self.g_q, x).reshape(b, t, -1)
        k = self._embed_apply(self.g_k, x).reshape(b, t, -1)
        theta = _theta(t, self.max_hop, float(self.alpha), str(x.device))
        sampling = self.training and self.sampler != "none"
        rb = self.sampler.startswith("relaxed_bernoulli")
        kw = dict(seed=seed, temperature=self.temperature,
                  sample=sampling and rb, nei_size=self.nei_size,
                  u=noise if (sampling and rb) else None, rows=rows)
        if sampling and self.sampler == "relaxed_bernoulli_sample":
            with torch.no_grad():   # .sample(): the draw is a constant
                adj = graph_adjacency(q, k, theta, **kw)
        else:
            adj = graph_adjacency(q, k, theta, **kw)
        if sampling and self.sampler == "gaussian":
            if noise is None:
                full, row0 = global_rows(adj.shape, rows)
                gen = torch.Generator(device=adj.device)
                gen.manual_seed(int(seed))
                noise = torch.randn(full, generator=gen, device=adj.device)
                noise = noise[row0:row0 + adj.shape[0]]
            adj = gaussian_perturb_sample(adj, noise, self.alpha)
        adj = adj.to(self.dtype)
        for gcn in self.gcns:
            x = gcn(x, adj)
        return x
