"""Fused train-mode SepConv3d pair with a three-sweep backward (K5).

Counterpart of ``video_graph_ssl_tpu/ops/fused_sepconv.py``.  The pair is
spatial (1,3,3) conv + BN + ReLU, then temporal (3,1,1) conv + BN + ReLU,
both convs unbiased, stride 1, pad 1, BN in train mode.  As one
differentiable function, its backward reads x, the cotangent and the
forward's batch statistics:

    sweep 1: y1, a, y2; the BN2 backward sums S_g2, S_gx2
    sweep 2: dz2 -> dy2 -> dWt, da, dz1 (kept in the compute dtype);
             the BN1 backward sums S_g1, S_gx1
    sweep 3: dz1 -> dy1 -> dWs, dx

(the BN train backward needs the batch sums of the cotangent before any
per-element gradient, so the sweeps cannot be merged).

On a CUDA tensor the backward launches the hand-written kernel family
``csrc/sepconv_bwd.cu`` (``ops/sepconv_bwd.py``); on a CPU tensor it runs
:func:`bwd_reference`, the plain PyTorch version that the tests hold
against JAX and ``chip_smoke.py`` holds the kernel to.  There is no
fallback from the kernel to the plain version.

The forward statistics are flax's fast-variance ones (mean and mean of
squares in fp32, variance clamped at 0), and the BN arithmetic runs in fp32
for every compute dtype, as in the JAX module, so the running statistics of
the fused path match JAX's fused path.

``sync`` (the mode of the pair's ``BatchNorm``s: ranks, or
``sync_bn.sum_form_bn`` on one process) takes both BNs over the global
batch, as the JAX package's fused pair does under a multi-device mesh: the
forward sums count, sum y and sum y^2 in fp32 over the ranks of the default
group (one all-reduce per BN, as ``SyncBatchNormFn``), and the backward
sums each of its two pairs of BN sums over the ranks between its sweeps
(``bwd_reference`` split at its sums; the kernel in three stages) and
divides them by the global row count.  The weight and BN-parameter
gradients stay the rank's own sums, for ``DistributedDataParallel`` to
average.

Tensors are ``(B, C, T, H, W)`` (the backbone's ``channels_last_3d``
activations) and the weights keep PyTorch's layout: ``ws (F, C, 1, 3, 3)``,
``wt (F, F, 3, 1, 1)``; BN parameters and statistics are ``(F,)``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..parallel import sync_bn
from . import sepconv_bwd

EPS = 1e-3  # BN epsilon of the S3D family

_DIMS = (0, 2, 3, 4)   # every axis but the channel


def _bc(v: torch.Tensor) -> torch.Tensor:
    """(F,) -> (1, F, 1, 1, 1), to broadcast against (B, F, T, H, W)."""
    return v.view(1, -1, 1, 1, 1)


def conv_s(x: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    return F.conv3d(x, ws, None, 1, (0, 1, 1))


def conv_t(a: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    return F.conv3d(a, wt, None, 1, (1, 0, 0))


def _stats(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax's fast-variance batch statistics, reduced in fp32."""
    yf = y.float()
    mu = yf.mean(dim=_DIMS)
    mu2 = (yf * yf).mean(dim=_DIMS)
    return mu, torch.clamp(mu2 - mu * mu, min=0.0)


def _global_stats(y: torch.Tensor, reduce: bool):
    """The fast-variance statistics over every rank's rows (``reduce``: of
    the default group) from count, sum y and sum y^2 in fp32; returns (mu,
    var, count), count an (F,) fp32 tensor of the global row count."""
    yf = y.float()
    stats = torch.stack([yf.sum(dim=_DIMS), (yf * yf).sum(dim=_DIMS),
                         torch.full_like(yf[0, :, 0, 0, 0], float(yf.numel() // yf.shape[1]))])
    del yf
    if reduce:
        sync_bn.all_reduce_sums(stats)
    count = stats[2]
    mu = stats[0] / count
    return mu, torch.clamp(stats[1] / count - mu * mu, min=0.0), count


def bn_relu(y: torch.Tensor, mu, var, gamma, beta, dtype) -> torch.Tensor:
    z = (y - _bc(mu)) * _bc(torch.rsqrt(var + EPS) * gamma) + _bc(beta)
    return torch.clamp(z, min=0.0).to(dtype)


def sepconv_fwd_core(x, ws, wt, g1, b1, g2, b2, dtype, sync: bool = False,
                     reduce: bool = False):
    """Forward returning (out, (mu1, var1, mu2, var2)), and with ``sync``
    the global row count as well: (out, stats, count).  ``reduce``: the
    statistics are summed over the ranks of the default group."""
    y1 = conv_s(x.to(dtype), ws.to(dtype))
    if sync:
        mu1, var1, count = _global_stats(y1, reduce)
    else:
        mu1, var1 = _stats(y1)
    a = bn_relu(y1.float(), mu1, var1, g1, b1, dtype)
    y2 = conv_t(a, wt.to(dtype))
    mu2, var2 = _global_stats(y2, reduce)[:2] if sync else _stats(y2)
    out = bn_relu(y2.float(), mu2, var2, g2, b2, dtype)
    if sync:
        return out, (mu1, var1, mu2, var2), count
    return out, (mu1, var1, mu2, var2)


def _bn_bwd_terms(dz: torch.Tensor, xhat: torch.Tensor):
    return dz.sum(dim=_DIMS), (dz * xhat).sum(dim=_DIMS)


def _dw_temporal(a: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dWt[f, f', k] = sum a[b, f', t+k-1, h, w] dy[b, f, t, h, w], summed in
    fp32 (float64 for float64 inputs)."""
    t = a.shape[2]
    acc = torch.promote_types(a.dtype, torch.float32)
    ap = F.pad(a.to(acc), (0, 0, 0, 0, 1, 1))
    dyf = dy.to(acc)
    taps = [torch.einsum("bcthw,bfthw->fc", ap[:, :, k:k + t], dyf)
            for k in range(3)]
    return torch.stack(taps, dim=-1)[..., None, None]


def _dw_spatial(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dWs[f, c, 0, kh, kw] = sum x[b, c, t, h+kh-1, w+kw-1] dy[b, f, t, h, w],
    summed in fp32 (float64 for float64 inputs)."""
    h, w = x.shape[3:]
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc), (1, 1, 1, 1))
    dyf = dy.to(acc)
    rows = [torch.stack([torch.einsum("bcthw,bfthw->fc",
                                      xp[:, :, :, kh:kh + h, kw:kw + w], dyf)
                         for kw in range(3)], dim=-1)
            for kh in range(3)]
    return torch.stack(rows, dim=-2)[:, :, None]


def _means(s_g, s_gx, n, reduce):
    """(mean of S_g, mean of S_gx) over n rows; with ``reduce``, of the sums
    over every rank (a copy of the local ones, summed in place)."""
    if reduce is None:
        return s_g / n, s_gx / n
    total = torch.stack([s_g, s_gx])
    reduce(total)
    return total[0] / n, total[1] / n


def bwd_reference(x, ws, wt, g1, b1, g2, b2, mu1, var1, mu2, var2, g, dtype,
                  count=None, reduce=None):
    """Plain PyTorch version of the three sweeps (the kernel's oracle).

    Returns (dx, dWs, dWt, dgamma1, dbeta1, dgamma2, dbeta2); the cast
    points are the JAX ``_bwd_reference``'s: y1, y2 and every conv output
    in the compute dtype, a, dy2 and dy1 cast to it before the products,
    dz1 kept in it, BN arithmetic and all sums in fp32.

    ``reduce`` (with ``count``, the global row count as an fp32 tensor):
    the split at the two sums, as the kernel's stages split; each pair of
    sums (S_g2, S_gx2, then S_g1, S_gx1) is summed over the ranks by
    ``reduce(t)`` (in place on a [2][F] tensor) and divided by ``count``
    for the next sweep, while the returned BN gradients stay this rank's."""
    n = x.shape[0] * x.shape[2] * x.shape[3] * x.shape[4] if count is None else count
    rs1 = torch.rsqrt(var1 + EPS)
    rs2 = torch.rsqrt(var2 + EPS)

    y1 = conv_s(x.to(dtype), ws.to(dtype)).float()
    xhat1 = (y1 - _bc(mu1)) * _bc(rs1)
    a = torch.clamp(xhat1 * _bc(g1) + _bc(b1), min=0.0).to(dtype)
    y2 = conv_t(a, wt.to(dtype)).float()
    xhat2 = (y2 - _bc(mu2)) * _bc(rs2)
    z2 = xhat2 * _bc(g2) + _bc(b2)

    gf = g.float()
    dz2 = torch.where(z2 > 0, gf, 0.0)
    s_g2, s_gx2 = _bn_bwd_terms(dz2, xhat2)
    m_g2, m_gx2 = _means(s_g2, s_gx2, n, reduce)
    dy2 = _bc(g2 * rs2) * (dz2 - _bc(m_g2) - xhat2 * _bc(m_gx2))

    dy2c = dy2.to(dtype)
    dwt = _dw_temporal(a, dy2c)
    da = F.conv_transpose3d(dy2c, wt.to(dtype), None, 1, (1, 0, 0)).float()

    z1 = xhat1 * _bc(g1) + _bc(b1)
    dz1 = torch.where(z1 > 0, da, 0.0)
    s_g1, s_gx1 = _bn_bwd_terms(dz1, xhat1)
    # dz1 is kept in the compute dtype (the sums above use it unrounded)
    dz1 = dz1.to(dtype).float()
    m_g1, m_gx1 = _means(s_g1, s_gx1, n, reduce)
    dy1 = _bc(g1 * rs1) * (dz1 - _bc(m_g1) - xhat1 * _bc(m_gx1))

    dy1c = dy1.to(dtype)
    dws = _dw_spatial(x.to(dtype), dy1c)
    dx = F.conv_transpose3d(dy1c, ws.to(dtype), None, 1, (0, 1, 1)).to(x.dtype)

    return (dx, dws.to(ws.dtype), dwt.to(wt.dtype),
            s_gx1.to(g1.dtype), s_g1.to(b1.dtype),
            s_gx2.to(g2.dtype), s_g2.to(b2.dtype))


class FusedSepConvTrain(torch.autograd.Function):
    """``apply(x, ws, wt, g1, b1, g2, b2, dtype, sync)`` -> (out, mu1, var1,
    mu2, var2).  The statistics carry no gradient: they feed the
    running-stat updates only.  The backward is K5 on CUDA tensors and
    :func:`bwd_reference` on CPU tensors; with ``sync`` both take the BN
    means over the global batch, reducing over the ranks when the default
    group spans more than one process."""

    @staticmethod
    def forward(ctx, x, ws, wt, g1, b1, g2, b2, dtype, sync=False):
        ctx.reduce = bool(sync) and sync_bn.across_ranks(None)
        res = sepconv_fwd_core(x, ws, wt, g1, b1, g2, b2, dtype, sync, ctx.reduce)
        out, stats = res[:2]
        ctx.save_for_backward(x, ws, wt, g1, b1, g2, b2, *stats, *res[2:])
        ctx.dtype = dtype
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, g, *_stat_grads):
        args = ctx.saved_tensors
        args, count = (args[:11], args[11]) if len(args) == 12 else (args, None)
        reduce = sync_bn.all_reduce_sums if ctx.reduce else None
        if args[0].device.type == "cpu":
            grads = bwd_reference(*args, g, ctx.dtype, count, reduce)
        elif reduce is None:
            grads = sepconv_bwd.sepconv_bwd(*args, g, ctx.dtype)
        else:
            grads = sepconv_bwd.sepconv_bwd(*args, g, ctx.dtype, count, reduce)
        return (*grads, None, None)


def fused_sepconv_train(x, ws, wt, g1, b1, g2, b2, dtype, sync: bool = False):
    """Train-mode SepConv pair: (out, (mu1, var1, mu2, var2)); ``sync``:
    the statistics and the backward's BN means over the global batch."""
    out, *stats = FusedSepConvTrain.apply(x, ws, wt, g1, b1, g2, b2, dtype, sync)
    return out, tuple(stats)
