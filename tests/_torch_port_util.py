"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py)."""

import jax
import numpy as np


def fill_variables(shapes, seed: int) -> dict:
    """Numpy values for a JAX variables tree given its ``jax.eval_shape``
    shapes, drawn from ``seed`` in path order: kernels ~ N(0, 1/fan_in),
    biases ~ N(0, 0.05), BN scales ~ U(0.5, 1.5), BN means ~ N(0, 0.1),
    BN variances ~ U(0.5, 1.5).  (Tracing ``init`` with ``eval_shape`` costs
    seconds where compiling it costs a minute on one core.)"""
    g = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in flat:
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(leaf.shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = g.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "scale" or name == "var":
            v = g.uniform(0.5, 1.5, shape)
        elif name == "mean":
            v = 0.1 * g.standard_normal(shape)
        else:
            v = 0.05 * g.standard_normal(shape)
        leaves.append(v.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
