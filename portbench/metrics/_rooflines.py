"""Bytes and operations of the hand-written kernels' calls in one step,
from the shapes of :mod:`._shapes`: each call's inputs read once and its
outputs written once, whatever the kernel reads again.

* K1 (graph adjacency), once per graph block and forward pass: reads q and
  k (B, T, D) in the compute dtype, writes the fp32 (3, B, T, T) adjacency,
  softmax and hop-weighted planes; 2 B T^2 D operations.
* K2 (GCN propagation), once per graph block and forward pass and once per
  block in each backward (dx through adj^T): reads adj (B, T, T) and x, writes
  an x-sized output, all in the compute dtype; 2 B T^2 (H W C) operations.
* K3/K4 (max-pool backward), once per 3D max pool in each backward: reads x
  and dy, writes dx, in the compute dtype.  y is not counted: x determines it.
"""

from __future__ import annotations

import math

from ._peaks import bound_s
from ._shapes import pass_shapes

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _n(shape) -> int:
    return math.prod(shape)


def graph_bound_s(settings: dict, forward: int, backward: int, ranks: int = 1) -> float:
    e = DTYPE_BYTES[settings["TPU.COMPUTE_DTYPE"]]
    total = 0.0
    for (b, t, d), x in pass_shapes(settings, ranks)["graphs"]:
        k1 = bound_s(2 * b * t * d * e + 3 * b * t * t * 4, 2 * b * t * t * d)
        k2 = bound_s(b * t * t * e + 2 * _n(x) * e, 2 * b * t * t * (_n(x) // (b * t)))
        total += forward * k1 + (forward + backward) * k2
    return total


def maxpool_bwd_bound_s(settings: dict, backward: int, ranks: int = 1) -> float:
    e = DTYPE_BYTES[settings["TPU.COMPUTE_DTYPE"]]
    return backward * sum(bound_s((2 * _n(x) + _n(y)) * e)
                          for x, y in pass_shapes(settings, ranks)["pools"])
