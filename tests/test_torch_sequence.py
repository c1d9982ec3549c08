"""The port's frame-axis ring of the graph block (``parallel/sequence.py``)
against the JAX package on the CPU.

The ring runs on 2 and 4 gloo ranks (``tests/_torch_dist_util.py``), each
holding T / P frames of a clip of the JAX test's size (B 2, T 16, 8x8x12,
two GCN layers, fp32), on the weights of a JAX ``TemporalGraphAug`` carried
through the weight bridge.  JAX's own tolerance holds throughout (2e-5,
``tests/test_sequence_parallel.py``): the output against JAX's
single-device module in eval; the sampled output against JAX's
``sp_graph_aug_apply`` on a one-device mesh with JAX's rowfold draws
injected (rel-L2, see the test); dx and the weight gradients (summed over the ranks) against
``jax.grad`` of the module, both in float64 (in fp32 the port's
single-device module already sits 5e-4 from JAX's dx in the largest
element, 6e-6 rel-L2: rounding, which the ring repeats); the port's own
draw the same for P = 1, 2, 4; and JAX's ``ValueError``s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_util import run_ranks, seq_worker
from _torch_port_util import fill_variables, rel_l2
from video_graph_ssl_tpu.ops.temporal_graph import TemporalGraphAug as JaxGraphAug
from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug
from video_graph_ssl_tpu_torch.parallel import (graph_aug_sequence_parallel, ring_propagate,
                                                ring_similarity, rowfold_bernoulli_sample)
from video_graph_ssl_tpu_torch.utils.jax_weights import graph_aug_state_dict

torch.set_num_threads(1)
B, T, H, W, C = 2, 16, 8, 8, 12
TOL = 2e-5
MODULE_KW = dict(in_channels=C, num_gcn_layers=2, dtype=torch.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def jax_rowfold_u(key, b, t, eps=1e-6):
    """JAX ``rowfold_bernoulli_sample``'s uniform draw for every (batch,
    global row): the same keys and calls, all rows at once."""
    keys = jax.vmap(lambda bi: jax.vmap(lambda ri: jax.random.fold_in(
        jax.random.fold_in(key, bi), ri))(jnp.arange(t)))(jnp.arange(b))
    return np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.uniform(
        k, (t,), jnp.float32, minval=eps, maxval=1.0 - eps)))(keys))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's references, and each P's ring runs in one spawn of the ranks."""
    g = np.random.default_rng(7)
    x = g.standard_normal((B, T, H, W, C)).astype(np.float32)
    gout = g.standard_normal((B, T, H, W, C)).astype(np.float32)
    mod = JaxGraphAug(num_gcn_layers=2, dtype=jnp.float32)
    variables = fill_variables(jax.eval_shape(
        lambda v: mod.init(jax.random.PRNGKey(0), v, train=False), jnp.asarray(x)), 3)
    params = variables["params"]

    want = mod.apply(variables, jnp.asarray(x), train=False)
    with jax.enable_x64():
        mod64 = JaxGraphAug(num_gcn_layers=2, dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)

        def loss(p, xx):
            return jnp.sum(mod64.apply({"params": p}, xx, train=False) * gout)

        gp, gx = jax.grad(loss, argnums=(0, 1))(p64, jnp.asarray(x, jnp.float64))
        gp, gx = jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx)

    from video_graph_ssl_tpu.parallel import make_mesh
    from video_graph_ssl_tpu.parallel.sequence import (
        graph_aug_sequence_parallel as jax_sp)
    key = jax.random.PRNGKey(123)
    mesh1 = make_mesh((1,), ("seq",), devices=jax.devices()[:1])
    sampled = np.asarray(jax_sp(variables, jnp.asarray(x), mesh1, seq_axis="seq",
                                sampler="relaxed_bernoulli", rng=key, dtype=jnp.float32))
    errors = {}
    for name, kw in (("sampler", dict(sampler="gaussian")),
                     ("rng", dict(sampler="relaxed_bernoulli"))):
        with pytest.raises(ValueError) as e:
            jax_sp(variables, jnp.asarray(x), mesh1, seq_axis="seq", dtype=jnp.float32, **kw)
        errors[name] = str(e.value)
    noise = jax_rowfold_u(key, B, T)

    sd = {k: np.ascontiguousarray(v) for k, v in
          graph_aug_state_dict(params, {}, sub_sample=True).items()}
    runs = [dict(x=x.astype(np.float64), gout=gout.astype(np.float64), float64=True),
            dict(x=x, kw=dict(sampler="relaxed_bernoulli"), noise=noise),
            dict(x=x, kw=dict(sampler="relaxed_bernoulli", rng=5)),
            dict(x=x, kw=dict(sampler="gaussian")),
            dict(x=x, kw=dict(sampler="relaxed_bernoulli")),
            dict(x=x[:, :6]),
            dict(x=x)]
    ranks = {p: run_ranks(seq_worker, p, tmp_path_factory.mktemp(f"p{p}"), MODULE_KW, sd,
                          runs) for p in (2, 4)}
    return dict(x=x, gout=gout, want=np.asarray(want), gx=gx, gp=gp,
                sampled=sampled, noise=noise, errors=errors, sd=sd, ranks=ranks)


def _gather(ranks, run, field="y"):
    return np.concatenate([r[run][field] for r in ranks], axis=1)


def _port_module(sd):
    m = TemporalGraphAug(**MODULE_KW)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return m


@pytest.mark.parametrize("p", [2, 4])
def test_ring_eval_matches_jax_module(setup, p):
    _close(_gather(setup["ranks"][p], 6), setup["want"])


@pytest.mark.parametrize("p", [2, 4])
def test_ring_gradients_match_jax_grad(setup, p):
    ranks = setup["ranks"][p]
    _close(_gather(ranks, 0, "dx"), setup["gx"])
    want = graph_aug_state_dict(setup["gp"], {}, sub_sample=True)
    grads = ranks[0][0]["grads"]
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        _close(g, want[name])
        for r in ranks[1:]:
            assert np.array_equal(r[0]["grads"][name], g), name


@pytest.mark.parametrize("p", [2, 4])
def test_ring_with_jax_draws_matches_jax_sp_apply(setup, p):
    """At 2e-5 rel-L2, against JAX's ring and against the port's
    single-device module with the same draw.  Elementwise, the
    relaxed-Bernoulli draw amplifies last-bit differences of the
    similarity by about 1 / p where p is small: the port's module sits
    4.2e-5 from JAX's ring in 18 of 24576 elements, and the 4-rank ring,
    whose block products round differently, 4.0e-5 from the module in 5."""
    sampled = _gather(setup["ranks"][p], 1)
    assert rel_l2(sampled, setup["sampled"]) < TOL
    module = _port_module(setup["sd"]).train()
    with torch.no_grad():
        alone = module(torch.from_numpy(setup["x"]),
                       noise=torch.from_numpy(setup["noise"].copy()))
    assert rel_l2(sampled, alone.numpy()) < TOL
    assert np.abs(sampled - setup["want"]).max() > 1e-3     # the draw changed it


def test_port_draw_is_the_same_for_every_p(setup):
    """The draw's rows are bit for bit the global draw's (see
    test_ring_pieces_single_process); the sampled outputs agree at 2e-5
    rel-L2 (elementwise the sampler amplifies rounding, as above)."""
    module = _port_module(setup["sd"])
    with torch.no_grad():
        one = graph_aug_sequence_parallel(module, torch.from_numpy(setup["x"]),
                                          sampler="relaxed_bernoulli", rng=5).numpy()
        eval_out = module.eval()(torch.from_numpy(setup["x"])).numpy()
    for p in (2, 4):
        assert rel_l2(_gather(setup["ranks"][p], 2), one) < TOL
    assert np.abs(one - eval_out).max() > 1e-3


def test_single_process_ring_equals_module(setup):
    """P = 1 (no process group): the module's own function, also with the
    draw injected as the module's ``noise``."""
    module = _port_module(setup["sd"]).train()
    x = torch.from_numpy(setup["x"])
    noise = torch.from_numpy(setup["noise"])
    with torch.no_grad():
        _close(graph_aug_sequence_parallel(module, x).numpy(),
               module.eval()(x).numpy())
        module.train()
        _close(graph_aug_sequence_parallel(module, x, sampler="relaxed_bernoulli",
                                           noise=noise).numpy(),
               module(x, noise=noise).numpy())


@pytest.mark.parametrize("p", [2, 4])
def test_jax_value_errors(setup, p):
    ranks = setup["ranks"][p]
    assert ranks[0][3]["error"] == setup["errors"]["sampler"]
    assert ranks[0][4]["error"] == setup["errors"]["rng"]
    if p == 4:
        assert ranks[0][5]["error"].startswith("T=6 not divisible")
    else:
        assert "y" in ranks[0][5]
    module = _port_module(setup["sd"])
    biased = TemporalGraphAug(C, num_gcn_layers=1, use_bias=True, dtype=torch.float32)
    bn = TemporalGraphAug(C, num_gcn_layers=1, bn_layer=True, dtype=torch.float32)
    x = torch.from_numpy(setup["x"])
    for m, what in ((biased, "use_bias"), (bn, "bn_layer")):
        with pytest.raises(ValueError, match=what):
            graph_aug_sequence_parallel(m, x)
    assert graph_aug_sequence_parallel(module, x).shape == x.shape


def test_ring_pieces_single_process():
    """P = 1: the similarity is q k^T in fp32, the propagation the plain
    K2 product, the draw the global one's rows; gradients by autograd."""
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn(2, 6, 5, generator=g, requires_grad=True) for _ in range(2))
    sim = ring_similarity(q, k)
    _close(sim.detach().numpy(), (q @ k.transpose(1, 2)).detach().numpy())
    sim.square().sum().backward()
    dq, dk = q.grad.clone(), k.grad.clone()
    q.grad = k.grad = None
    (q @ k.transpose(1, 2)).square().sum().backward()
    _close(dq.numpy(), q.grad.numpy())
    _close(dk.numpy(), k.grad.numpy())
    adj = torch.rand(2, 6, 6, generator=g, requires_grad=True)
    sup = torch.randn(2, 6, 3, 3, 4, generator=g, requires_grad=True)
    out = ring_propagate(adj, sup)
    ref = torch.einsum("bij,bjf->bif", adj, sup.reshape(2, 6, -1)).reshape(sup.shape)
    _close(out.detach().numpy(), ref.detach().numpy())
    out.square().sum().backward()
    da, ds = adj.grad.clone(), sup.grad.clone()
    adj.grad = sup.grad = None
    ref.square().sum().backward()
    _close(da.numpy(), adj.grad.numpy())
    _close(ds.numpy(), sup.grad.numpy())
    p = torch.rand(2, 3, 12, generator=g)
    rows = rowfold_bernoulli_sample(9, p, 0.5, 6)
    full = rowfold_bernoulli_sample(9, torch.cat([torch.rand(2, 6, 12), p,
                                                  torch.rand(2, 3, 12)], 1), 0.5, 0)
    assert torch.equal(rows, full[:, 6:9])
