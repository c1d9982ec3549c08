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
* TF "SAME" padding (I3D's pools; JAX ``i3d._same_max_pool``, flax
  ``nn.max_pool(padding="SAME")``): forward and plain backward against it
  and ``jax.grad`` on tie-free fp32 inputs, to 1e-6, at each I3D pool
  geometry with odd and even extents (high pad one more than the low, and
  equal to it), plus a geometry that ``ceil_mode`` cannot express (the
  -inf copy); the pads against ``lax.padtype_to_pads``; and at every pool
  of I3D's steps (16x112x112, 16x224x224, and the CPU tests' 8x32x32 and
  16x64x64) ``F.max_pool3d(padding=lo, ceil_mode=True)`` has the windows of
  the (lo, hi) pads: the same outputs as the -inf-padded input's pool.
* On the card (``cuda`` marker, ``python -m pytest -m cuda
  tests/test_torch_maxpool.py``): the kernel against the plain version, bit
  for bit, on the same geometries plus ragged C, odd H/W and T = 1, in fp32
  and bf16, with one launch and one allocation (dx) per call; and at the
  224x224 stem and Mixed_3b pools, whose slabs the kernel cuts into
  strips; and at the TF "SAME" geometries.  JAX is imported inside the
  tests that use it, so the file also runs where JAX is absent.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from video_graph_ssl_tpu_torch.models.layers import MaxPool3d
from video_graph_ssl_tpu_torch.ops import maxpool
from video_graph_ssl_tpu_torch.utils import tracing

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
    import jax
    import jax.numpy as jnp
    from video_graph_ssl_tpu.models.layers import max_pool_3d, max_pool_3d_ref

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


# on the card: GRID, then ragged C (12 in bf16, 6 in fp32: the kernel's
# scalar path), odd H and W, and T = 1 where the window fits
CARD_SHAPES = [(2, 5, 9, 7, None), (2, 1, 9, 9, None)]
CARD_GRID = [(case, shape, dt) for dt in (torch.float32, torch.bfloat16)
             for case, shape in GRID + [
                 (case, shape[:4] + ((12 if dt == torch.bfloat16 else 6),))
                 for case in CASES for shape in CARD_SHAPES
                 if shape[1] + 2 * case[2][0] >= case[0][0]]]
CARD_IDS = [f"{str(dt)[6:]}-k{''.join(map(str, c[0]))}s{''.join(map(str, c[1]))}-"
            f"{'x'.join(map(str, shape))}" for c, shape, dt in CARD_GRID]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_call(x, y, dy, k, s, p):
    """One backward call: (dx, wrapper calls counted, allocations made)."""
    n = tracing.counters()
    before = (n["maxpool_bwd_s1"], n["maxpool_bwd_strided"])
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    dx = maxpool._launch(x, y, dy, k, s, p)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
    n = tracing.counters()
    counted = (n["maxpool_bwd_s1"] - before[0], n["maxpool_bwd_strided"] - before[1])
    return dx, counted, allocs


def _kernel_equals_plain(case, shape, dtype, dev):
    """Random inputs and cotangent, then the tie-rich bf16 inputs with a
    ones cotangent of test_plain_matches_torch_autograd_bf16_ties: the
    kernel equals the plain version bit for bit; each call is one counted
    launch whose only allocation is dx (no tap scratch)."""
    k, s, p = case
    g = np.random.default_rng(5)
    cl = torch.channels_last_3d
    ties = _ncdhw(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    for x, ones in ((_ncdhw(g.standard_normal(shape).astype(np.float32)), False),
                    (ties, True)):
        x = x.to(dtype).to(dev).contiguous(memory_format=cl)
        y = F.max_pool3d(x, k, s, p).contiguous(memory_format=cl)
        dy = (torch.ones_like(y) if ones else torch.from_numpy(
            g.standard_normal(tuple(y.shape)).astype(np.float32)).to(dev, dtype)
            .contiguous(memory_format=cl))
        dx, counted, allocs = _card_call(x, y, dy, k, s, p)
        assert counted == ((1, 0) if s == (1, 1, 1) else (0, 1))
        assert allocs == 1 and dx.dtype == dtype
        want = maxpool.max_pool3d_bwd_plain(x.cpu(), y.cpu(), dy.cpu(), k, s, p)
        assert torch.equal(dx.cpu(), want), float((dx.cpu().float() - want.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case,shape,dtype", CARD_GRID, ids=CARD_IDS)
def test_kernel_equals_plain_on_card(case, shape, dtype):
    _kernel_equals_plain(case, shape, dtype, _cuda())


# 224x224 pools whose slabs exceed one block (batch cut to keep the CPU
# oracle quick): stage 1's pool in frame strips, Mixed_3b's in clip strips
STRIP_SHAPES = {"stem_224": (CASES[3], (4, 8, 112, 112, 64)),
                "mixed_3b_224": (CASES[0], (8, 8, 28, 28, 192))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(STRIP_SHAPES))
def test_kernel_equals_plain_on_card_in_strips(name, dtype):
    dev = _cuda()
    case, (b, t, h, w, c) = STRIP_SHAPES[name]
    plan = maxpool.bwd_plan((b, c, t, h, w), *case, dtype)
    assert plan.t_strips * plan.h_strips > 1
    _kernel_equals_plain(case, (b, t, h, w, c), dtype, dev)


# --------------------------------------------------------------------------- #
# TF "SAME" padding: I3D's pools, (window, stride) with an even and an odd
# x (B, T, H, W, C); the last geometry pads (0, 1) at stride 1, which
# ceil_mode cannot express (the forward pads a copy with -inf)
# --------------------------------------------------------------------------- #
SAME_GRID = [(((1, 3, 3), (1, 2, 2)), (2, 4, 10, 10, 8)),    # pool_1/4: H, W (0, 1)
             (((1, 3, 3), (1, 2, 2)), (2, 3, 9, 7, 8)),      # H, W (1, 1)
             (((3, 3, 3), (2, 2, 2)), (2, 8, 14, 14, 8)),    # pool_7: (0, 1)
             (((3, 3, 3), (2, 2, 2)), (2, 5, 7, 9, 8)),      # (1, 1)
             (((2, 2, 2), (2, 2, 2)), (2, 4, 7, 7, 8)),      # pool_13: T none, H, W (0, 1)
             (((2, 2, 2), (2, 2, 2)), (2, 4, 8, 6, 8)),      # none
             (((3, 3, 3), (1, 1, 1)), (2, 4, 5, 6, 8)),      # Mixed pools: (1, 1)
             (((2, 2, 2), (1, 1, 1)), (2, 3, 5, 4, 8))]      # (0, 1) at stride 1: the copy
SAME_IDS = ["pool1_even", "pool1_odd", "pool7_even", "pool7_odd", "pool13_odd",
            "pool13_even", "mixed", "copy"]


@pytest.mark.parametrize("case,shape", SAME_GRID, ids=SAME_IDS)
def test_same_pool_matches_jax_tie_free(case, shape):
    """``MaxPool3d(k, s, "SAME")``: pads, forward and the plain backward
    through autograd against flax's SAME pool and ``jax.grad``."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    k, s = case
    g = np.random.default_rng(6)
    x = g.permutation(np.prod(shape)).reshape(shape).astype(np.float32)
    x = x / x.size - 0.5                            # distinct values: no ties
    pads = jax.lax.padtype_to_pads(shape[1:4], k, s, "SAME")
    assert maxpool.same_padding(shape[1:4], k, s) == tuple(map(tuple, pads))
    assert maxpool.ceil_mode_matches(shape[1:4], k, s, pads) == (case != SAME_GRID[-1][0])

    def pool(v):
        return nn.max_pool(v, window_shape=k, strides=s, padding="SAME")

    y_ref = np.asarray(pool(jnp.asarray(x)))
    gy = g.standard_normal(y_ref.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(pool(v) * gy))(jnp.asarray(x)))
    xt = _ncdhw(x).requires_grad_()
    y = MaxPool3d(k, s, "SAME")(xt)
    np.testing.assert_array_equal(np.transpose(y.detach().numpy(), (0, 2, 3, 4, 1)), y_ref)
    y.backward(_ncdhw(gy))
    got = np.transpose(xt.grad.numpy(), (0, 2, 3, 4, 1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _i3d_pool_inputs():
    """(x (B, C, T, H, W), window, stride, pads) of every pool of I3D's
    steps: kernel_times' tables at 16x112x112 and 16x224x224 (batch and
    channels cut to 1 and 2, which the windows do not depend on), and the
    pools a port I3D runs on 8x32x32 and 16x64x64 clips."""
    from video_graph_ssl_tpu_torch.kernel_times import geometry
    from video_graph_ssl_tpu_torch.models.i3d import I3D

    seen = set()
    for size, batch in ((112, 128), (224, 32)):
        for _, _, (_, t, h, w, _), k, s, p in geometry(size, batch, "I3D")[2]:
            seen.add(((1, 2, t, h, w), k, s, p))
    forward = maxpool.pool_forward

    def record(x, k, s, pads, **kw):
        seen.add(((1, 2) + tuple(x.shape[2:]), tuple(k), tuple(s), tuple(pads)))
        return forward(x, k, s, pads, **kw)

    maxpool.pool_forward = record
    try:
        with torch.no_grad():
            model = I3D(dtype=torch.float32).eval()
            for t, hw in ((8, 32), (16, 64)):
                model(torch.zeros(1, t, hw, hw, 3))
    finally:
        maxpool.pool_forward = forward
    return sorted(seen)


def test_ceil_mode_gives_the_windows_of_every_i3d_pool():
    """Where the high pad is one more than the low, the forward pools with
    ``ceil_mode`` (no copy); at every I3D pool that must be the pool of the
    input padded with -inf: the same outputs on tie-free inputs, and the
    same chosen inputs."""
    cases = _i3d_pool_inputs()
    assert len(cases) > 20
    asym = 0
    for shape, k, s, pads in cases:
        assert maxpool.ceil_mode_matches(shape[2:], k, s, pads), (shape, k, s, pads)
        asym += any(lo != hi for lo, hi in pads)
        x = torch.randperm(int(np.prod(shape)), generator=torch.Generator().manual_seed(1))
        x = x.reshape(shape).float()
        lo = tuple(p[0] for p in pads)
        y, idx = F.max_pool3d(x, k, s, lo, ceil_mode=True, return_indices=True)
        flat = (*pads[2], *pads[1], *pads[0])
        y_ref = F.max_pool3d(F.pad(x, flat, value=float("-inf")), k, s, 0)
        assert y.shape == y_ref.shape == (1, 2) + maxpool.out_sizes(shape[2:], k, s, pads)
        assert torch.equal(y, y_ref)
        assert torch.equal(x.flatten(2).gather(2, idx.flatten(2)), y.flatten(2))
    assert asym >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case,shape", SAME_GRID, ids=SAME_IDS)
def test_kernel_equals_plain_on_card_same(case, shape, dtype):
    """K3/K4 with TF "SAME" pads (the low pad and the true output extents)
    against the plain version, bit for bit, one launch per call."""
    dev = _cuda()
    (k, s), cl = case, torch.channels_last_3d
    g = np.random.default_rng(7)
    for c in (shape[4], 12 if dtype == torch.bfloat16 else 6):   # and ragged C
        x = _ncdhw(g.standard_normal(shape[:4] + (c,)).astype(np.float32))
        x = x.to(dev, dtype).contiguous(memory_format=cl)
        pads = maxpool.same_padding(x.shape[2:], k, s)
        y = maxpool.pool_forward(x, k, s, pads).contiguous(memory_format=cl)
        dy = torch.from_numpy(g.standard_normal(tuple(y.shape)).astype(np.float32)).to(
            dev, dtype).contiguous(memory_format=cl)
        dx, counted, allocs = _card_call(x, y, dy, k, s, "SAME")
        assert counted == ((1, 0) if s == (1, 1, 1) else (0, 1)) and allocs == 1
        want = maxpool.max_pool3d_bwd_plain(x.cpu(), y.cpu(), dy.cpu(), k, s, pads)
        assert torch.equal(dx.cpu(), want)
