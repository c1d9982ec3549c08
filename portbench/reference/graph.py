"""The GCA temporal-graph block in plain float32 PyTorch, with the noise
draw of the measured program.

    q, k  = per-frame 1x1x1 embeddings to C/2 channels, max-pooled 2x2 / 2,
            flattened to (B, T, D)
    S     = softmax_j(q k^T)
    p     = S * theta          (theta(h) = e^-h / (1 + e^-2h) + alpha, hops <= 3)
    adj   = sigmoid((logit(clip(p)) + logit(u)) / tau)     (train mode)
    out   = adj @ W x + W x     (one GCN layer with its skip)

The noise ``u`` is what the program draws.  On a CUDA device that is the
adjacency kernel's Philox4x32-10, keyed by the 64-bit block seed, with
counter (element i * T + j, clip): :func:`philox_uniform` computes the same
32-bit words with integer tensor arithmetic.  On the CPU it is a
``torch.Generator`` draw (:func:`generator_uniform`), as the program's plain
version makes it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from .nn import Rounding, bmm, linear

EPS = 1e-6
MASK32 = 0xFFFF_FFFF
MASK63 = 0x7FFF_FFFF_FFFF_FFFF


def stage_seed(seed: int, idx: int) -> int:
    """A block's seed from the pass's graph seed and the block's stage."""
    return (int(seed) * 1_000_003 + 7919 * (int(idx) + 1)) & MASK63


def hop_weights(t: int, max_hop: int = 3, alpha: float = 0.5) -> np.ndarray:
    """(T, T) theta(|i - j|) within ``max_hop`` frames, 0 beyond."""
    hops = np.abs(np.arange(t)[:, None] - np.arange(t)[None, :])
    w = np.zeros((t, t), np.float32)
    for d in range(max_hop + 1):
        e = math.exp(-d)
        w[hops == d] = e / (1.0 + e * e) + alpha
    return w


def _mul32(a: torch.Tensor, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the product of uint32 ``a`` (int64
    tensor) and the constant ``b``, in 16-bit limbs so that int64 holds
    every partial product."""
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi & MASK32, lo & MASK32


def philox_uniform(shape, seed: int, clip0: int, device) -> torch.Tensor:
    """(B, T, T) float32 U(eps, 1 - eps) of the adjacency kernel: the first
    word of Philox4x32-10 at counter (i * T + j, clip0 + b, 0, 0) under the
    key (low, high) of ``seed``, as ``(bits >> 8) * 2^-24 + 2^-25``."""
    b, t, _ = shape
    idx = torch.arange(t * t, device=device, dtype=torch.int64)
    clip = torch.arange(b, device=device, dtype=torch.int64) + int(clip0)
    c0 = idx[None].expand(b, -1).clone()
    c1 = clip[:, None].expand(-1, t * t).clone()
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    s = int(seed) & 0xFFFF_FFFF_FFFF_FFFF
    k0, k1 = s & MASK32, (s >> 32) & MASK32
    for _ in range(10):
        hi0, lo0 = _mul32(c0, 0xD2511F53)
        hi1, lo1 = _mul32(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & MASK32, (k1 + 0xBB67AE85) & MASK32
    u = (c0 >> 8).to(torch.float32) * 5.9604644775390625e-08 + 2.98023223876953125e-08
    return u.clamp(EPS, 1.0 - EPS).reshape(b, t, t)


def generator_uniform(shape, seed: int, device) -> torch.Tensor:
    """U(eps, 1 - eps) of the program's plain version (CPU tensors)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & MASK63)
    u = torch.rand(tuple(shape), generator=g, device=device, dtype=torch.float32)
    return u * (1.0 - 2.0 * EPS) + EPS


def draw_uniform(shape, seed: int, device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "meta":
        return torch.full(tuple(shape), 0.5, device=device)
    if device.type == "cuda":
        return philox_uniform(shape, seed, 0, device)
    return generator_uniform(shape, seed, device)


def relaxed_bernoulli(p: torch.Tensor, u: torch.Tensor, temperature: float) -> torch.Tensor:
    pc = p.clamp(EPS, 1.0 - EPS)
    logits = torch.log(pc) - torch.log1p(-pc) + torch.log(u) - torch.log1p(-u)
    return torch.sigmoid(logits / temperature)


class GCN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, 1, bias=False)

    def forward(self, x: torch.Tensor, adj: torch.Tensor, r: Rounding) -> torch.Tensor:
        b, t = x.shape[:2]
        w = self.conv.weight.reshape(self.conv.weight.shape[0], -1)
        support = linear(x, w, None, r)                               # (B, T, H, W, C)
        out = bmm(adj, support.reshape(b, t, -1), r).reshape(support.shape)
        return out + support


class TemporalGraphAug(nn.Module):
    """The block with the shipped settings (sub-sampling max pool, no
    biases, no BN, one GCN layer, relaxed-Bernoulli sampler)."""

    def __init__(self, cin: int, max_hop: int = 3, alpha: float = 0.5,
                 temperature: float = 1.0):
        super().__init__()
        inter = max(cin // 2, 1)
        self.max_hop, self.alpha, self.temperature = max_hop, alpha, temperature
        self.g_q = nn.Sequential(nn.Conv3d(cin, inter, 1, bias=False), nn.MaxPool2d(2, 2))
        self.g_k = nn.Sequential(nn.Conv3d(cin, inter, 1, bias=False), nn.MaxPool2d(2, 2))
        self.gcns = nn.ModuleList([GCN(cin, cin)])
        self.rounding = Rounding()
        # (B, T, D) of the last forward's q and k, (B, T, H, W, C) of its GCN
        # input: the shapes the benchmark's byte counts read
        self.last_shapes = None

    def _embed(self, m: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        conv, pool = m[0], m[1]
        h = linear(x, conv.weight.reshape(conv.weight.shape[0], -1), None, self.rounding)
        b, t, hh, ww, c = h.shape
        h2 = pool(h.reshape(b * t, hh, ww, c).permute(0, 3, 1, 2))
        return h2.permute(0, 2, 3, 1).reshape(b, t, -1)

    def forward(self, x: torch.Tensor, seed: int) -> torch.Tensor:
        """``x`` (B, T, H, W, C) -> the same shape."""
        r = self.rounding
        b, t = x.shape[:2]
        q, k = self._embed(self.g_q, x), self._embed(self.g_k, x)
        self.last_shapes = (tuple(q.shape), tuple(x.shape))
        theta = torch.from_numpy(hop_weights(t, self.max_hop, self.alpha)).to(x.device)
        s = torch.softmax(bmm(q, k.transpose(1, 2), r), dim=-1)
        p = s * theta[None]
        if self.training:
            adj = relaxed_bernoulli(p, draw_uniform(p.shape, seed, x.device), self.temperature)
        else:
            adj = p
        for gcn in self.gcns:
            x = gcn(x, adj, r)
        return x
