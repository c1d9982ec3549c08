"""Batch normalisation over the global batch of all ranks.

The JAX package computes BN statistics over the whole sharded batch: under
sharded ``jit`` XLA adds the cross-device sum to flax's reductions
(``video_graph_ssl_tpu/models/layers.py``), and ``TPU.SYNC_BN`` selects
nothing else.  :class:`SyncBatchNormFn` is that reduction for ranks under
``torch.distributed`` (torch's ``SyncBatchNorm`` has no CPU kernels for its
primitives and keeps torch's running-statistics rule, not flax's):

* forward: each rank's per-channel count, sum and sum of squares, in fp32
  (in float64 for float64 inputs); one ``all_reduce`` sums them, and the
  global mean and biased variance follow in flax's fast-variance form
  ``E[x^2] - E[x]^2``;
* backward: one ``all_reduce`` of the per-channel sums of dy and dy * x_hat
  over the global batch, then the usual BN input gradient.  The weight and
  bias gradients stay the rank's own sums: ``DistributedDataParallel``
  averages them with the other parameters' gradients.

On one process (no group, or a group of one) the function reduces nothing.
:func:`per_rank_bn` switches a module's BN layers to per-rank statistics for
a block of code; only ShuffleBN's key pass (``parallel/shuffle_bn.py``)
asks for that.  :func:`sum_form_bn` runs this function on one process,
where BN otherwise takes ``native_batch_norm``'s statistics: it is the
one-process reference that differs from the ranks' step only in the order
of its sums.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch
import torch.distributed as dist
from torch import nn


def _reduce_dims(x: torch.Tensor) -> List[int]:
    return [0] + list(range(2, x.dim()))


def across_ranks(group=None) -> bool:
    """Whether ``group`` (None: the default group) spans more than one
    process."""
    return dist.is_initialized() and dist.get_world_size(group) > 1


def all_reduce_sums(t: torch.Tensor, group=None) -> None:
    """Sum ``t`` (fp32 sums, on the current stream) over the ranks of
    ``group`` in place: this module's forward and backward statistics, and
    the fused SepConv pair's (``ops/fused_sepconv.py``, K5's stages)."""
    dist.all_reduce(t, group=group)


def _bc(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(C,) -> broadcastable against x (N, C, ...)."""
    return v.reshape([1, -1] + [1] * (x.dim() - 2))


class SyncBatchNormFn(torch.autograd.Function):
    """``y = (x - mean) * rsqrt(var + eps) * weight + bias`` over the global
    batch; x is (N, C, ...) with C on dim 1.  Returns (y in x's dtype, the
    global mean, the global biased variance), the statistics in the
    parameters' dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group):
        pd = weight.dtype
        xf = x.to(pd)
        dims = _reduce_dims(x)
        stats = torch.stack([xf.sum(dims), (xf * xf).sum(dims),
                             torch.full_like(weight, float(x.numel() // x.shape[1]))])
        del xf
        ctx.reduce = across_ranks(group)
        if ctx.reduce:
            all_reduce_sums(stats, group)
        count = stats[2]
        gmean = stats[0] / count
        gvar = (stats[1] / count - gmean * gmean).clamp_min(0.0)
        y = torch.nn.functional.batch_norm(x, gmean, gvar, weight, bias, False, 0.0, eps)
        invstd = torch.rsqrt(gvar + eps)
        ctx.save_for_backward(x, weight, gmean, invstd, count)
        ctx.group = group
        ctx.mark_non_differentiable(gmean, gvar)
        return y, gmean, gvar

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, count = ctx.saved_tensors
        pd = weight.dtype
        dims = _reduce_dims(x)
        dyf = dy.to(pd)
        xhat = (x.to(pd) - _bc(mean, x)) * _bc(invstd, x)
        sums = torch.stack([dyf.sum(dims), (dyf * xhat).sum(dims)])
        dweight, dbias = sums[1].clone(), sums[0].clone()
        if ctx.reduce:
            all_reduce_sums(sums, ctx.group)
        mdy, mdyx = sums[0] / count, sums[1] / count
        dx = (dyf - _bc(mdy, x) - xhat * _bc(mdyx, x)) * _bc(weight * invstd, x)
        return dx.to(x.dtype), dweight, dbias, None, None


@contextlib.contextmanager
def _bn_mode(module: nn.Module, mode: str):
    from ..models.layers import BatchNorm

    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        setattr(m, mode, True)
    try:
        yield
    finally:
        for m in bns:
            setattr(m, mode, False)


def per_rank_bn(module: nn.Module):
    """Inside the block, the train-mode BN layers of ``module`` normalise
    with this rank's statistics only."""
    return _bn_mode(module, "per_rank")


def sum_form_bn(module: nn.Module):
    """Inside the block, the train-mode BN layers of ``module`` take their
    statistics through :class:`SyncBatchNormFn` even on one process."""
    return _bn_mode(module, "sum_form")


def bn_buffers(module: nn.Module) -> List[torch.Tensor]:
    """The running statistics of every BN layer of ``module``."""
    from ..models.layers import BatchNorm

    return [b for m in module.modules() if isinstance(m, BatchNorm)
            for b in (m.running_mean, m.running_var)]
