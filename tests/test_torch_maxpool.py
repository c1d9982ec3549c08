"""The port's max-pool backward (plain version of kernels K3/K4,
``video_graph_ssl_tpu_torch/ops/maxpool.py``) on the CPU.

* Against torch autograd of ``F.max_pool3d``, exactly: in fp32 on random
  inputs (both add an input's contributions in increasing output order),
  and in bf16 on inputs that tie under rounding with a ones cotangent
  (first-tap tie rule; integer sums), for the pool geometries of
  ``tests/test_maxpool.py`` plus a ragged shape.
* Against ``jax.grad`` of the JAX package's ``max_pool_3d`` (where-chain /
  reduce_window) and ``max_pool_3d_ref`` on tie-free fp32 inputs, to 1e-6.
  The JAX K3/K4 kernels run only on a TPU, so the JAX side is its plain
  reference, as in ``tests/test_maxpool.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from video_graph_ssl_tpu.models.layers import max_pool_3d, max_pool_3d_ref
from video_graph_ssl_tpu_torch.models.layers import MaxPool3d
from video_graph_ssl_tpu_torch.ops import maxpool

torch.set_num_threads(1)

CASES = [
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)),    # inception block branch pool (K3)
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),    # pool_7 (K4)
    ((2, 2, 2), (2, 2, 2), (0, 0, 0)),    # pool_13 (K4)
    ((1, 3, 3), (1, 2, 2), (0, 1, 1)),    # pool_1 / pool_4 (K4)
    ((2, 2, 2), (1, 1, 1), (0, 0, 0)),    # even window, stride 1 (K3)
]
SHAPES = [(2, 6, 9, 9, 8)] * len(CASES)
GRID = list(zip(CASES, SHAPES)) + [(CASES[1], (2, 5, 9, 9, 16))]   # + ragged
IDS = ["s1", "pool7", "pool13", "pool1", "even_s1", "ragged_pool7"]


def _ncdhw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 4, 1, 2, 3))))


def _torch_grad(x: torch.Tensor, gy_fn, k, s, p):
    xt = x.clone().requires_grad_()
    y = F.max_pool3d(xt, k, s, p)
    y.backward(gy_fn(y))
    return y.detach(), xt.grad


@pytest.mark.parametrize("case,shape", GRID, ids=IDS)
def test_plain_matches_torch_autograd_fp32(case, shape):
    k, s, p = case
    g = np.random.default_rng(0)
    x = _ncdhw(g.standard_normal(shape).astype(np.float32))
    y_shape = F.max_pool3d(x, k, s, p).shape
    gy = torch.from_numpy(g.standard_normal(tuple(y_shape)).astype(np.float32))
    y, ref = _torch_grad(x, lambda _: gy, k, s, p)
    dx = maxpool.max_pool3d_bwd_plain(x, y, gy, k, s, p)
    assert dx.dtype == torch.float32
    assert torch.equal(dx, ref)


@pytest.mark.parametrize("case,shape", GRID, ids=IDS)
def test_plain_matches_torch_autograd_bf16_ties(case, shape):
    """bf16 rounding makes many windows tie; a ones cotangent keeps the
    sums integral, so any difference is a tie routed elsewhere."""
    k, s, p = case
    x = _ncdhw(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    x = x.to(torch.bfloat16)
    y, ref = _torch_grad(x, torch.ones_like, k, s, p)
    xq = x.float()
    assert len(torch.unique(xq)) < xq.numel()     # the input does tie
    dx = maxpool.max_pool3d_bwd_plain(x, y, torch.ones_like(y), k, s, p)
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dx, ref)


@pytest.mark.parametrize("case,shape", GRID, ids=IDS)
def test_module_grad_matches_jax_tie_free(case, shape):
    """MaxPool3d (forward and plain backward through autograd) against
    jax.grad of the JAX max_pool_3d and max_pool_3d_ref."""
    k, s, p = case
    g = np.random.default_rng(2)
    x = g.permutation(np.prod(shape)).reshape(shape).astype(np.float32)
    x = x / x.size - 0.5                            # distinct values: no ties
    y_shape = jax.eval_shape(lambda v: max_pool_3d_ref(v, k, s, p),
                             jnp.asarray(x)).shape
    gy = g.standard_normal(y_shape).astype(np.float32)

    def loss(fn):
        return lambda v: jnp.sum(fn(v, k, s, p) * gy)

    want = [np.asarray(jax.jit(jax.grad(loss(fn)))(jnp.asarray(x)))
            for fn in (max_pool_3d, max_pool_3d_ref)]
    xt = _ncdhw(x).requires_grad_()
    y = MaxPool3d(k, s, p)(xt)
    np.testing.assert_array_equal(
        np.transpose(y.detach().numpy(), (0, 2, 3, 4, 1)),
        np.asarray(max_pool_3d_ref(jnp.asarray(x), k, s, p)))
    y.backward(_ncdhw(gy))
    got = np.transpose(xt.grad.numpy(), (0, 2, 3, 4, 1))
    for w in want:
        np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6)


def test_channels_last_input_and_float64():
    """The backbone's channels_last_3d layout and the float64 parity runs
    take the same plain path."""
    k, s, p = CASES[0]
    x = torch.randn(2, 8, 4, 5, 5, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    x = x.contiguous(memory_format=torch.channels_last_3d).requires_grad_()
    y = maxpool.max_pool3d(x, k, s, p)
    gy = torch.randn(y.shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(4))
    y.backward(gy)
    _, ref = _torch_grad(x.detach(), lambda _: gy, k, s, p)
    assert x.grad.dtype == torch.float64
    torch.testing.assert_close(x.grad, ref, rtol=1e-12, atol=1e-12)
