"""The port's graph ops against the JAX package on the CPU, fp32.

K1 (graph adjacency) and K2 (GCN propagation) run their plain PyTorch
versions here (CPU tensors); the CUDA kernels are held to those plain
versions on the card by ``chip_smoke.py``.  The JAX Pallas adjacency kernel
has no interpret mode, so K1 is held to ``graph_adjacency_xla`` and
``relaxed_bernoulli_sample``; K2 to the Pallas kernel in interpret mode.
Inputs come from numpy with a seed; the relaxed-Bernoulli noise is the JAX
draw, injected into the port.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from video_graph_ssl_tpu.ops import temporal_graph as jtg
from video_graph_ssl_tpu.ops.pallas.gcn_propagate import (
    _propagate_pallas, gcn_propagate as jax_gcn_propagate)
from video_graph_ssl_tpu.ops.pallas.graph_kernel import graph_adjacency_xla
from video_graph_ssl_tpu_torch.ops import gcn_propagate as tgp
from video_graph_ssl_tpu_torch.ops import graph_kernel as tgk
from video_graph_ssl_tpu_torch.ops import temporal_graph as ttg
from video_graph_ssl_tpu_torch.utils import tracing
from video_graph_ssl_tpu_torch.utils.jax_weights import graph_aug_state_dict

torch.set_num_threads(1)
EPS = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _qk(seed=0, b=2, t=8, d=24):
    g = np.random.default_rng(seed)
    q = g.standard_normal((b, t, d)).astype(np.float32) / d ** 0.25
    k = g.standard_normal((b, t, d)).astype(np.float32) / d ** 0.25
    return q, k, jtg.hop_weight_matrix(t, 3, 0.5)


@pytest.mark.parametrize("t,max_hop,alpha", [(8, 3, 0.5), (5, 1, 0.2), (2, 3, 0.5)])
def test_hop_matrices_match_jax(t, max_hop, alpha):
    np.testing.assert_array_equal(ttg.temporal_hop_matrix(t, max_hop),
                                  jtg.temporal_hop_matrix(t, max_hop))
    np.testing.assert_array_equal(ttg.hop_weight_matrix(t, max_hop, alpha),
                                  jtg.hop_weight_matrix(t, max_hop, alpha))


def test_k1_plain_unsampled_matches_xla():
    q, k, theta = _qk(0)
    ref = graph_adjacency_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(theta),
                              None, 1.0, False)
    out = tgk.graph_adjacency(_t(q), _t(k), _t(theta), sample=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_k1_plain_sampled_matches_relaxed_bernoulli(temperature):
    q, k, theta = _qk(1)
    key = jax.random.key(7)
    p = graph_adjacency_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(theta),
                            None, 1.0, False)
    ref = jtg.relaxed_bernoulli_sample(key, p, temperature)
    u = jax.random.uniform(key, p.shape, jnp.float32, EPS, 1.0 - EPS)
    out = tgk.graph_adjacency(_t(q), _t(k), _t(theta), temperature=temperature,
                              sample=True, u=_t(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # the port's public sampler is the same function of (p, u)
    np.testing.assert_allclose(
        ttg.relaxed_bernoulli_sample(_t(p), _t(u), temperature).numpy(),
        np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("closed_form", [False, True], ids=["autograd", "closed_form"])
@pytest.mark.parametrize("sample", [False, True])
def test_k1_grads_match_jax(sample, closed_form):
    """dq, dk of the plain version (autograd) and of the kernel's
    closed-form backward (fed the plain forward) against jax.grad."""
    q, k, theta = _qk(2)
    key = jax.random.key(3)
    gout = np.random.default_rng(4).standard_normal((2, 8, 8)).astype(np.float32)
    u = jax.random.uniform(key, (2, 8, 8), jnp.float32, EPS, 1.0 - EPS)

    def loss(qq, kk):
        a = graph_adjacency_xla(qq, kk, jnp.asarray(theta), key, 0.7, sample)
        return jnp.sum(a * gout)

    dq_ref, dk_ref = jax.grad(loss, (0, 1))(jnp.asarray(q), jnp.asarray(k))
    qt, kt = _t(q).requires_grad_(), _t(k).requires_grad_()
    args = (qt, kt, _t(theta), _t(u), 0, 0.7, sample, 0)
    if closed_form:
        adj = tgk.GraphAdjacencyFn.apply(tgk._adjacency_fwd_plain, *args)
    else:
        adj = tgk.graph_adjacency_plain(qt, kt, _t(theta), 0, 0.7, sample, _t(u))
    (adj * _t(gout)).sum().backward()
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(dq_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(dk_ref), rtol=1e-5, atol=1e-5)


def test_k1_plain_draw_is_seeded():
    q, k, theta = _qk(5)
    a = tgk.graph_adjacency(_t(q), _t(k), _t(theta), seed=11)
    b = tgk.graph_adjacency(_t(q), _t(k), _t(theta), seed=11)
    c = tgk.graph_adjacency(_t(q), _t(k), _t(theta), seed=12)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def _adj_x(seed, shape=(2, 4, 3, 5, 8)):
    g = np.random.default_rng(seed)
    b, t = shape[:2]
    return (g.uniform(0, 1, (b, t, t)).astype(np.float32),
            g.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("transpose", [False, True])
def test_k2_plain_matches_interpret(transpose):
    adj, x = _adj_x(0)
    ja = jnp.asarray(adj)
    ref = _propagate_pallas(ja.transpose(0, 2, 1) if transpose else ja,
                            jnp.asarray(x), interpret=True)
    out = tgp.propagate_plain(_t(adj), _t(x), transpose=transpose)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_k2_plain_bf16_contract():
    adj, x = _adj_x(1)
    ref = jax_gcn_propagate(jnp.asarray(adj, jnp.bfloat16),
                            jnp.asarray(x, jnp.bfloat16), True)
    out = tgp.gcn_propagate(_t(adj).bfloat16(), _t(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_k2_grads_match_jax():
    adj, x = _adj_x(2)
    gout = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def loss(a, xx):
        return jnp.sum(jax_gcn_propagate(a, xx, True) * gout)

    da_ref, dx_ref = jax.grad(loss, (0, 1))(jnp.asarray(adj), jnp.asarray(x))
    at, xt = _t(adj).requires_grad_(), _t(x).requires_grad_()
    (tgp.gcn_propagate(at, xt) * _t(gout)).sum().backward()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(da_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), rtol=1e-5, atol=1e-5)


def test_wrappers_count_no_launch_on_cpu():
    tracing.reset_counters()
    q, k, theta = _qk(6)
    tgk.graph_adjacency(_t(q), _t(k), _t(theta))
    adj, x = _adj_x(6)
    tgp.gcn_propagate(_t(adj), _t(x))
    n = tracing.counters()
    assert n["graph_adjacency"] == 0 and n["gcn_propagate"] == 0


def test_kernel_entry_points_refuse_cpu_tensors():
    """The kernel paths never run the plain version: handed CPU tensors,
    they raise before any launch."""
    q, k, theta = _qk(7)
    with pytest.raises(ValueError, match="CUDA"):
        tgk.adjacency_fwd_kernel(_t(q), _t(k), _t(theta), None, 0, 1.0, True, 0)
    adj, x = _adj_x(7)
    with pytest.raises(ValueError, match="CUDA"):
        tgp._launch(_t(adj), _t(x), transpose=False)


# --------------------------------------------------------------------------- #
# TemporalGraphAug: forward, grads and BN stats against the JAX module
# --------------------------------------------------------------------------- #
GRAPH_CASES = {
    "sampler_none": dict(sampler="none"),
    "rb_injected": dict(sampler="relaxed_bernoulli"),
    "rb_bn_avg_2gcn_mask_bias": dict(
        sampler="relaxed_bernoulli", bn_layer=True, max_pool=False,
        num_gcn_layers=2, mask_frame=True, nei_size=2, use_bias=True,
        temperature=0.5),
    "no_subsample_bn": dict(sampler="relaxed_bernoulli", sub_sample=False,
                            bn_layer=True),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_temporal_graph_aug_matches_jax(case, monkeypatch):
    kw = GRAPH_CASES[case]
    g = np.random.default_rng(10)
    x = g.standard_normal((2, 4, 6, 6, 8)).astype(np.float32)
    # cotangent scaled so that the parameter grads are O(1)
    gout = 0.05 * g.standard_normal(x.shape).astype(np.float32)
    jmod = jtg.TemporalGraphAug(dtype=jnp.float32, **kw)
    variables = jmod.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False)
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    drawn = []
    orig = jtg.relaxed_bernoulli_sample

    def capture(key, probs, temperature, eps=1e-6):
        drawn.append(jax.random.uniform(key, probs.shape, jnp.float32, eps, 1 - eps))
        return orig(key, probs, temperature, eps)

    monkeypatch.setattr(jtg, "relaxed_bernoulli_sample", capture)

    def loss(p, xx):
        out, muts = jmod.apply({"params": p, "batch_stats": stats}, xx, train=True,
                               rngs={"graph": jax.random.key(1)},
                               mutable=["batch_stats"])
        return jnp.sum(out * gout), (out, muts.get("batch_stats", {}))

    (_, (out_ref, new_stats)), (dp_ref, dx_ref) = jax.value_and_grad(
        loss, (0, 1), has_aux=True)(params, jnp.asarray(x))

    tmod = ttg.TemporalGraphAug(8, dtype=torch.float32, **kw)
    sub = kw.get("sub_sample", True)
    tmod.load_state_dict({k: _t(v) for k, v in
                          graph_aug_state_dict(params, stats, sub).items()}, strict=True)
    tmod.train()
    noise = _t(drawn[0]) if drawn else None
    xt = _t(x).requires_grad_()
    out = tmod(xt, seed=0, noise=noise)
    (out * _t(gout)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), rtol=1e-4, atol=1e-5)
    ref_grads = graph_aug_state_dict(dp_ref, stats, sub)
    grads = dict(tmod.named_parameters())
    assert set(grads) == set(k for k in ref_grads if "running" not in k)
    for name, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    if kw.get("bn_layer"):
        ref_sd = graph_aug_state_dict(params, new_stats, sub)
        for name, buf in tmod.named_buffers():
            np.testing.assert_allclose(buf.numpy(), ref_sd[name], rtol=1e-4,
                                       atol=1e-6, err_msg=name)
