"""The port's fused SepConv pair (``ops/fused_sepconv.py``, the plain
version of kernel K5) against the JAX package on the CPU.

Shapes are those of ``tests/test_fused_sepconv.py`` (B, T, H, W, C, F =
2, 4, 6, 6, 5, 7), inputs from numpy with a seed.  JAX's K5/K6 Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
The port keeps PyTorch layouts: x (B, C, T, H, W), ws (F, C, 1, 3, 3),
wt (F, F, 3, 1, 1).

On the card (``cuda`` marker, ``python -m pytest -m cuda
tests/test_torch_fused_sepconv.py``): the kernel's tensor-core route
against ``bwd_reference`` at a small aligned shape and an S3D shape, a
cotangent that is a channel slice against its copy (bit-equal), two calls
bit-equal, and the route counters.  JAX is imported inside the tests that
use it, so the file also runs where JAX is absent.
"""

import numpy as np
import pytest
import torch

from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.models.layers import SepConv3d
from video_graph_ssl_tpu_torch.ops import fused_sepconv as fs
from video_graph_ssl_tpu_torch.ops import sepconv_bwd as sb
from video_graph_ssl_tpu_torch.utils import jax_weights, tracing

torch.set_num_threads(1)
B, T, H, W, C, F = 2, 4, 6, 6, 5, 7
GRAD_NAMES = ["dx", "dWs", "dWt", "dg1", "db1", "dg2", "db2"]


def _inputs(seed=0):
    """JAX-layout numpy inputs of tests/test_fused_sepconv.py: (x, ws, wt,
    g1, b1, g2, b2) and a cotangent."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    x = r.standard_normal((B, T, H, W, C)).astype(f32)
    ws = (0.3 * r.standard_normal((1, 3, 3, C, F))).astype(f32)
    wt = (0.3 * r.standard_normal((3, 1, 1, F, F))).astype(f32)
    g1 = (1.0 + 0.1 * r.standard_normal(F)).astype(f32)
    b1 = (0.1 * r.standard_normal(F)).astype(f32)
    g2 = (1.0 + 0.1 * r.standard_normal(F)).astype(f32)
    b2 = (0.1 * r.standard_normal(F)).astype(f32)
    gout = r.standard_normal((B, T, H, W, F)).astype(f32)
    return (x, ws, wt, g1, b1, g2, b2), gout


def _act(a: np.ndarray) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, C, T, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 4, 1, 2, 3))))


def _act_np(t: torch.Tensor) -> np.ndarray:
    return np.transpose(t.detach().numpy(), (0, 2, 3, 4, 1))


def _kernel(k: np.ndarray) -> torch.Tensor:
    """JAX (kt, kh, kw, Cin, Cout) -> PyTorch (Cout, Cin, kt, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2))))


def _kernel_np(t: torch.Tensor) -> np.ndarray:
    return np.transpose(t.detach().numpy(), (2, 3, 4, 1, 0))


def _port_args(args):
    x, ws, wt, g1, b1, g2, b2 = args
    return (_act(x), _kernel(ws), _kernel(wt),
            *(torch.from_numpy(v) for v in (g1, b1, g2, b2)))


def _grads_np(grads):
    dx, dws, dwt, *bn = grads
    return [_act_np(dx), _kernel_np(dws), _kernel_np(dwt)] + [g.detach().numpy() for g in bn]


def test_fwd_core_and_stats_match_jax():
    import jax.numpy as jnp
    from video_graph_ssl_tpu.ops import fused_sepconv as jfs

    args, _ = _inputs()
    out_ref, stats_ref = jfs.sepconv_fwd_core(*map(jnp.asarray, args), jnp.float32)
    out, stats = fs.sepconv_fwd_core(*_port_args(args), torch.float32)
    np.testing.assert_allclose(_act_np(out), np.asarray(out_ref), rtol=1e-5, atol=1e-5)
    for got, want in zip(stats, stats_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _jax_bwd(name, args, gout):
    """The JAX backward named ``name`` on the same inputs."""
    import jax.numpy as jnp
    from video_graph_ssl_tpu.ops import fused_sepconv as jfs
    from video_graph_ssl_tpu.ops.pallas.sepconv_bwd import sepconv_bwd_pallas
    from video_graph_ssl_tpu.ops.pallas.sepconv_bwd_grid import sepconv_bwd_pallas_grid

    ja = tuple(map(jnp.asarray, args))
    _, stats = jfs.sepconv_fwd_core(*ja, jnp.float32)
    g = jnp.asarray(gout)
    if name == "reference":
        return jfs._bwd_reference(ja + tuple(stats) + (jnp.float32,), g)
    if name == "pallas":
        return sepconv_bwd_pallas(*ja, *stats, g, jnp.float32, interpret=True)
    return sepconv_bwd_pallas_grid(*ja, *stats, g, jnp.float32, interpret=True,
                                   h_tile=int(name[len("grid_h"):]))


@pytest.mark.parametrize("jax_bwd", ["reference", "pallas", "grid_h2", "grid_h3",
                                     "grid_h6"])
def test_bwd_reference_matches_jax(jax_bwd):
    """bwd_reference against JAX ``_bwd_reference`` and the K5 (resident)
    and K6 (H-slab grid; slabs of 2, 3 and 6 rows) kernels in interpret
    mode."""
    args, gout = _inputs(4)
    want = _jax_bwd(jax_bwd, args, gout)
    pargs = _port_args(args)
    _, stats = fs.sepconv_fwd_core(*pargs, torch.float32)
    got = fs.bwd_reference(*pargs, *stats, _act(gout), torch.float32)
    for name, g, w in zip(GRAD_NAMES, _grads_np(got), want):
        w = np.asarray(w).reshape(g.shape)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


def test_fused_grads_match_autograd_of_unfused():
    """The three-sweep backward == torch autograd of the plain forward,
    through the train-mode batch statistics."""
    args, gout = _inputs(1)
    gt = _act(gout)

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in _port_args(args)]
        out = fn(*leaves, torch.float32)[0]
        (out * gt).sum().backward()
        return [a.grad for a in leaves]

    plain = grads(fs.sepconv_fwd_core)
    fused = grads(fs.fused_sepconv_train)
    for name, a, b in zip(GRAD_NAMES, fused, plain):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4, msg=name)


def test_stats_carry_no_gradient():
    args, _ = _inputs()
    leaves = [a.clone().requires_grad_() for a in _port_args(args)]
    out, stats = fs.fused_sepconv_train(*leaves, torch.float32)
    assert not any(s.requires_grad for s in stats)
    (out.sum() * 0 + sum(s.sum() for s in stats)).backward()
    for a in leaves:
        assert a.grad is None or float(a.grad.abs().max()) == 0.0


def test_sepconv_module_fused_matches_jax():
    """SepConv3d(fused_bwd=True) against JAX SepConv3d(fused_bwd=True):
    train forward, running statistics, eval forward, parameter and input
    gradients."""
    import jax
    import jax.numpy as jnp
    from _torch_port_util import np_tree
    from video_graph_ssl_tpu.models.layers import SepConv3d as JaxSepConv3d

    r = np.random.default_rng(2)
    x = r.standard_normal((2, 4, 8, 8, 12)).astype(np.float32)
    jm = JaxSepConv3d(16, 3, 1, 1, fused_bwd=True, dtype=jnp.float32,
                      param_dtype=jnp.float32)
    v = jax.jit(jm.init)(jax.random.key(5), jnp.asarray(x))
    v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: a + 0.1 * r.standard_normal(a.shape).astype(np.float32),
        v["batch_stats"])}
    sd = {}
    jax_weights._sep(sd, "m", v["params"], v["batch_stats"])
    m = SepConv3d(12, 16, 3, 1, 1, dtype=torch.float32, fused_bwd=True)
    assert m.fused
    state = {k[2:]: torch.from_numpy(np.array(a)) for k, a in sd.items()}
    m.load_state_dict(state, strict=True)

    y_ref, new_stats = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    xt = _act(x).requires_grad_()
    y = m.train()(xt)
    np.testing.assert_allclose(_act_np(y), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    sd_new = {}
    jax_weights._sep(sd_new, "m", v["params"], np_tree(new_stats["batch_stats"]))
    for k, a in m.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(a.numpy(), sd_new["m." + k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)

    wloss = r.standard_normal(np.asarray(y_ref).shape).astype(np.float32)

    def loss(params, xx):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                          xx, True, mutable=["batch_stats"])
        return jnp.sum(out * wloss)

    gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    (y * _act(wloss)).sum().backward()
    np.testing.assert_allclose(_act_np(xt.grad), np.asarray(gx), rtol=2e-4, atol=2e-4)
    sd_g = {}
    jax_weights._sep(sd_g, "m", np_tree(gp), v["batch_stats"])
    for k, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), sd_g["m." + k], rtol=2e-4,
                                   atol=2e-4, err_msg=k)

    m.load_state_dict(state, strict=True)   # undo the train step's stat update
    m.eval()
    with torch.no_grad():
        y = m(_act(x))
    y_ref = jm.apply(v, jnp.asarray(x), False)
    np.testing.assert_allclose(_act_np(y), np.asarray(y_ref), rtol=1e-5, atol=1e-5)


def test_sepconv_fused_needs_s3d():
    from test_torch_models import s3d_cfg

    cfg = s3d_cfg()
    cfg.TPU.SEPCONV_FUSED = True
    cfg.MODEL.BACKBONE = "tiny3d"
    with pytest.raises(ValueError, match="SEPCONV_FUSED only applies to S3D"):
        create_visual_model(cfg)


# --------------------------------------------------------------------------- #
# on the card: the kernel (csrc/sepconv_bwd.cu) against bwd_reference

# rel-L2 per output, bf16 (chip_smoke.py's TOL_K5): both round y1, y2, da and
# the conv outputs to bf16 but sum in other orders, and a pre-activation
# within a rounding step of 0 may land on the other side of its ReLU
TOL_BF16 = 2e-2


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_args(shape, dtype, dev, seed=0, g_pad=0):
    """bwd_reference's arguments on the card for (B, T, H, W, C, F), from a
    seeded CPU generator; the cotangent is a channel slice of a
    channels_last_3d tensor ``g_pad`` channels wider (0: the whole tensor)."""
    b, t, h, w, c, f = shape
    r = torch.Generator().manual_seed(seed)
    cl = torch.channels_last_3d
    x = torch.randn(b, c, t, h, w, generator=r).to(dev, dtype).contiguous(memory_format=cl)
    ws = (torch.randn(f, c, 1, 3, 3, generator=r) / (9 * c) ** 0.5).to(dev)
    wt = (torch.randn(f, f, 3, 1, 1, generator=r) / (3 * f) ** 0.5).to(dev)
    bn = [(1 + 0.1 * torch.randn(f, generator=r) if i % 2 == 0
           else 0.1 * torch.randn(f, generator=r)).to(dev) for i in range(4)]
    _, stats = fs.sepconv_fwd_core(x, ws, wt, *bn, dtype)
    wide = torch.randn(b, f + g_pad, t, h, w, generator=r).to(dev, dtype).contiguous(
        memory_format=cl)
    g = wide[:, g_pad // 2:g_pad // 2 + f]
    return (x, ws, wt, *bn, *stats, g, dtype)


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 6, 6, 16, 24), (128, 4, 7, 7, 24, 64)],
                         ids=["small_aligned", "mixed_4c_b2"])
def test_cuda_tc_matches_reference(shape):
    dev = _cuda()
    args = _card_args(shape, torch.bfloat16, dev)
    assert sb.plan(*shape, torch.bfloat16).route == "tc"
    got = sb.sepconv_bwd(*args)
    want = fs.bwd_reference(*args)
    for name, a, r in zip(GRAD_NAMES, got, want):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.isfinite(a).all(), name
        assert _rel_l2(a, r) < TOL_BF16, (name, _rel_l2(a, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["tc", "simt"])
def test_cuda_cotangent_slice_is_read_in_place(dtype):
    """A channel slice of a wider channels_last_3d cotangent (an Inception
    concat's gradient), the same values laid out (B, T, C, H, W) (the
    head's gradient at Mixed_5c) and NCDHW give the bits of a contiguous
    channels_last_3d copy, with no copy made; a cotangent in another dtype
    is converted and counted."""
    dev = _cuda()
    shape = (2, 4, 6, 6, 16, 24)
    args = _card_args(shape, dtype, dev, g_pad=16)
    g = args[-2]
    assert not g.is_contiguous(memory_format=torch.channels_last_3d)
    tracing.reset_counters()
    want = sb.sepconv_bwd(*args[:-2], g.contiguous(memory_format=torch.channels_last_3d),
                          dtype)
    btchw = g.permute(0, 2, 1, 3, 4).contiguous().permute(0, 2, 1, 3, 4)
    for layout in (g, btchw, g.contiguous()):
        got = sb.sepconv_bwd(*args[:-2], layout, dtype)
        for name, a, b in zip(GRAD_NAMES, got, want):
            assert torch.equal(a, b), name
    assert tracing.counters()["sepconv_g_copies"] == 0
    other = torch.float64 if dtype == torch.float32 else torch.float32
    sb.sepconv_bwd(*args[:-2], g.to(other), dtype)
    assert tracing.counters()["sepconv_g_copies"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((128, 2, 3, 3, 160, 320), torch.bfloat16),
                                         ((2, 4, 6, 6, 16, 24), torch.bfloat16),
                                         ((2, 4, 6, 6, 5, 7), torch.float32)],
                         ids=["tc_mixed_5b", "tc_small", "simt_small"])
def test_cuda_two_calls_bit_equal(shape, dtype):
    dev = _cuda()
    args = _card_args(shape, dtype, dev, seed=3)
    first = sb.sepconv_bwd(*args)
    second = sb.sepconv_bwd(*args)
    for name, a, b in zip(GRAD_NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_route_counters():
    dev = _cuda()
    tracing.reset_counters()
    for shape, dtype, tc in (((2, 4, 6, 6, 16, 24), torch.bfloat16, 1),
                             ((2, 4, 6, 6, 16, 24), torch.float32, 0),
                             ((2, 4, 6, 6, 5, 7), torch.bfloat16, 0)):
        n = tracing.counters()
        before = (n["sepconv_bwd"], n["sepconv_bwd_tc"])
        sb.sepconv_bwd(*_card_args(shape, dtype, dev))
        n = tracing.counters()
        assert (n["sepconv_bwd"], n["sepconv_bwd_tc"]) == (before[0] + 1, before[1] + tc)
        assert sb.plan(*shape, dtype).route == ("tc" if tc else "simt")
