"""Activation recompute (``TPU.REMAT``), the port's counterpart of the JAX
backbones' ``nn.remat`` (``video_graph_ssl_tpu/models/s3d.py:115-123``,
``i3d.py:157-159``, ``resnet3d.py:189-190``, ``resnet2p1d.py:134-135``).

A backbone built with ``remat`` runs each of its recompute units (S3D's and
I3D's stages other than the pools, a 3D ResNet's residual blocks) through
:func:`run`: in a training forward that records a graph, the unit goes
through ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``,
so its backward recomputes the unit's forward from its input instead of
keeping the activations inside it.  The policies (``models/build.py:
resolve_remat``):

* ``True`` (``block``): keep nothing inside the unit.
* ``"conv_saved"``: keep every convolution's output and recompute the BN
  and ReLU epilogues (JAX's ``save_only_these_names("conv_out")``), as
  selective checkpointing that saves ``aten.convolution`` and the stems'
  ``vgs_torch::stem_conv3d_fwd``.

JAX's recompute is functional: the BN statistics it recomputes are thrown
away.  The port's BNs update their running statistics in place inside
``forward`` (``layers.BatchNorm``, ``layers.SepConv3d._fused_train``), so
the recompute would apply the momentum a second time.  The recompute
context therefore sets a flag, :func:`recomputing`, and those updates are
skipped while it is set; the recomputed batch statistics and outputs are
the first forward's, bit for bit.  The flag is thread-local because the
recompute runs on whichever thread runs the backward (autograd's device
thread for CUDA tensors), inside the context that sets it.

In eval mode, or without a graph (``torch.no_grad()``, the key pass), a
unit runs plainly.  The graph blocks stay outside every unit, so K1 never
runs again in a backward and draws its noise once.  Across ranks the
recompute runs the cross-rank BN's all-reduces (``parallel/sync_bn.py``)
and K5's staged BN sums again, during the backward, in the same order on
every rank.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.stem_conv import stem_conv3d_fwd_op

Policy = Union[bool, str]
POLICIES = (False, True, "conv_saved")

_state = threading.local()


def recomputing() -> bool:
    """Whether this thread is inside a unit's recompute."""
    return getattr(_state, "depth", 0) > 0


@contextlib.contextmanager
def _recompute_scope():
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1


def _save_convs(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op == torch.ops.aten.convolution.default or op == stem_conv3d_fwd_op:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _block_contexts():
    return contextlib.nullcontext(), _recompute_scope()


def _conv_saved_contexts():
    forward_ctx, recompute_ctx = create_selective_checkpoint_contexts(_save_convs)

    @contextlib.contextmanager
    def recompute():
        with recompute_ctx, _recompute_scope():
            yield

    return forward_ctx, recompute()


def check_policy(policy: Policy) -> Policy:
    if policy not in POLICIES:
        raise ValueError(f"remat must be one of {POLICIES}, got {policy!r}")
    return policy


def run(unit: nn.Module, x: torch.Tensor, policy: Policy) -> torch.Tensor:
    """``unit(x)``, recomputed in the backward under ``policy`` when this is
    a training forward that records a graph."""
    if not policy or not unit.training or not torch.is_grad_enabled():
        return unit(x)
    contexts = _conv_saved_contexts if policy == "conv_saved" else _block_contexts
    # the units draw no random numbers (the graph blocks stay outside)
    return checkpoint(unit, x, use_reentrant=False, context_fn=contexts,
                      preserve_rng_state=False)
