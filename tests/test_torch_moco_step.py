"""The port's MoCo pretrain step against the JAX package on the CPU, fp32.

* Lockstep: tiny3d + graph block (sampler none), one shared initial state
  (the JAX init carried into the port through the weight bridge, the JAX
  queue copied), one pre-augmented batch, three steps of each package's
  ``make_moco_step``.  Loss, params, EMA params, BN statistics, queue and
  pointer agree to 1e-4 relative (rel-L2 per tensor).
* SGD grouping: the port's two ``torch.optim.SGD`` groups against the JAX
  optax chain over three steps.
* The small pieces of the step: LR schedule, top-k, the queue ring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import rel_l2
from video_graph_ssl_tpu.engine import (create_pretrain_state as jax_state,
                                        make_pretrain_step)
from video_graph_ssl_tpu.engine.pretrain import topk_accuracy as jax_topk
from video_graph_ssl_tpu.memory.moco import MocoState as JaxMoco
from video_graph_ssl_tpu.memory.moco import moco_enqueue as jax_enqueue
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu.solver.build import make_lr_scheduler as jax_lr
from video_graph_ssl_tpu.solver.build import make_optimizer as jax_optimizer
from video_graph_ssl_tpu.solver.build import set_learning_rate as jax_set_lr
from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
from video_graph_ssl_tpu_torch.engine.pretrain import make_moco_step, topk_accuracy
from video_graph_ssl_tpu_torch.memory.moco import MocoState, moco_enqueue
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.solver.build import (make_lr_scheduler,
                                                    make_optimizer,
                                                    set_learning_rate)
from video_graph_ssl_tpu_torch.utils.jax_weights import (load_pretrain_weights,
                                                         pretrain_state_dict)

torch.set_num_threads(1)
B, T, H, W = 4, 4, 16, 16
LRS = (0.1, 0.05, 0.1)


def _moco_cfg(tiny_cfg):
    c = tiny_cfg.clone()
    c.CONTRAST.MEM_TYPE = "moco"
    c.GRAPH.SAMPLER = "none"
    return c


def _sd_of(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def test_moco_step_lockstep_with_jax(tiny_cfg):
    c = _moco_cfg(tiny_cfg)
    clips = np.random.default_rng(0).standard_normal(
        (B, 2, T, H, W, 3)).astype(np.float32)
    jmodel, _ = jax_create(c)
    state, tx = jax_state(c, jmodel, jnp.asarray(clips[:2, 0]), n_data=32)
    jstep = jax.jit(make_pretrain_step(c, jmodel, tx))

    model, _ = create_visual_model(c)
    load_pretrain_weights(model, state.params, state.batch_stats, "tiny3d")
    tstate = create_pretrain_state(c, model, "cpu")
    tstate.contrast.queue.copy_(torch.from_numpy(np.array(state.contrast.queue)))
    tstep = make_moco_step(float(c.CONTRAST.NCE_T), float(c.CONTRAST.ALPHA))

    batch = {"clips": jnp.asarray(clips), "label": jnp.zeros((B,), jnp.int32),
             "index": jnp.arange(B, dtype=jnp.int32)}
    for lr in LRS:
        state, jm = jstep(state, batch, lr)
        tm = tstep(tstate, torch.from_numpy(clips), lr)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
        for k in ("top1", "top5"):
            assert float(tm[k]) == pytest.approx(float(jm[k]))

    assert tstate.step == int(state.step) == len(LRS)
    assert tstate.contrast.ptr == int(state.contrast.ptr) == (B * len(LRS)) % 16
    assert rel_l2(tstate.contrast.queue.numpy(), state.contrast.queue) < 1e-4
    for name, (port, params, stats) in {
            "model": (tstate.model, state.params, state.batch_stats),
            "ema": (tstate.ema_model, state.ema_params, state.ema_batch_stats),
    }.items():
        ref = pretrain_state_dict(params, stats, "tiny3d")
        ours = _sd_of(port)
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert rel_l2(ours[k], ref[k]) < 1e-4, f"{name}: {k}"
    # the EMA moved, and by less than the params
    assert not np.array_equal(_sd_of(tstate.ema_model)["model.proj_head.head.0.weight"],
                              _sd_of(tstate.model)["model.proj_head.head.0.weight"])


@pytest.mark.parametrize("nesterov,wd_bias", [(False, 0.0), (True, 1e-3)])
def test_sgd_groups_match_optax_chain(tiny_cfg, nesterov, wd_bias):
    """weight decay per group, bias lr factor, momentum: torch param groups
    against the optax masks, over three steps with a changing lr."""
    c = tiny_cfg.clone()
    c.SOLVER.NESTEROV = nesterov
    c.SOLVER.WEIGHT_DECAY_BIAS = wd_bias
    net = torch.nn.Sequential(torch.nn.Conv3d(3, 4, 1), torch.nn.BatchNorm3d(4),
                              torch.nn.Linear(4, 5))
    g = np.random.default_rng(1)
    for p in net.parameters():
        p.data = torch.from_numpy(g.standard_normal(p.shape).astype(np.float32))
    # the JAX tree, named as flax names these leaves
    names = {"0.weight": ("conv", "kernel"), "0.bias": ("conv", "bias"),
             "1.weight": ("bn", "scale"), "1.bias": ("bn", "bias"),
             "2.weight": ("fc", "kernel"), "2.bias": ("fc", "bias")}
    params = {}
    for tname, (mod, leaf) in names.items():
        params.setdefault(mod, {})[leaf] = jnp.asarray(
            net.state_dict()[tname].numpy())
    tx = jax_optimizer(c, params)
    opt_state = tx.init(params)
    opt = make_optimizer(c, net)
    for lr in LRS:
        grads = {n: g.standard_normal(p.shape).astype(np.float32)
                 for n, p in net.named_parameters()}
        jgrads = {}
        for tname, (mod, leaf) in names.items():
            jgrads.setdefault(mod, {})[leaf] = jnp.asarray(grads[tname])
        opt_state = jax_set_lr(opt_state, lr)
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for n, p in net.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        set_learning_rate(opt, lr)
        opt.step()
    for tname, (mod, leaf) in names.items():
        np.testing.assert_allclose(net.state_dict()[tname].numpy(),
                                   np.asarray(params[mod][leaf]),
                                   rtol=1e-6, atol=1e-6, err_msg=tname)


@pytest.mark.parametrize("sched,method", [("step", "linear"), ("cos", "constant"),
                                          ("poly", "linear")])
def test_lr_schedule_matches_jax(tiny_cfg, sched, method):
    c = tiny_cfg.clone()
    c.SOLVER.LR_SCHEDULER = sched
    c.SOLVER.WARMUP_METHOD = method
    c.SOLVER.WARMUP_ITERS = 5
    c.SOLVER.MAX_EPOCHS = 40
    c.SOLVER.STEPS = (10, 20)
    ours, ref = make_lr_scheduler(c), jax_lr(c)
    for epoch in range(40):
        assert ours(epoch) == pytest.approx(ref(epoch), rel=1e-12)


def test_topk_accuracy_matches_jax():
    g = np.random.default_rng(2)
    logits = g.integers(0, 4, (16, 9)).astype(np.float32)   # many ties
    labels = g.integers(0, 9, 16)
    ref = jax_topk(jnp.asarray(logits), jnp.asarray(labels, jnp.int32))
    ours = topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    for k in ("top1", "top5"):
        assert float(ours[k]) == pytest.approx(float(ref[k]))


def test_moco_enqueue_ring_matches_jax():
    g = np.random.default_rng(3)
    queue = g.standard_normal((10, 4)).astype(np.float32)
    jstate = JaxMoco(jnp.asarray(queue), jnp.asarray(7, jnp.int32))
    tstate = MocoState(torch.from_numpy(queue.copy()), 7)
    for _ in range(3):   # wraps around the ring
        keys = g.standard_normal((4, 4)).astype(np.float32)
        jstate = jax_enqueue(jstate, jnp.asarray(keys))
        moco_enqueue(tstate, torch.from_numpy(keys))
        assert tstate.ptr == int(jstate.ptr)
        np.testing.assert_array_equal(tstate.queue.numpy(), np.asarray(jstate.queue))


def test_both_passes_of_a_step_share_the_graph_seed(tiny_cfg, monkeypatch):
    """As the JAX step hands the key and query passes the same step_rngs,
    the port keys both passes' graph noise with one seed per step (and aug
    point), and a new seed each step."""
    from video_graph_ssl_tpu_torch.ops import temporal_graph as ttg

    c = tiny_cfg.clone()
    c.CONTRAST.MEM_TYPE = "moco"     # sampler: relaxed_bernoulli (default)
    seeds = []
    orig = ttg.graph_adjacency

    def spy(q, k, theta, seed=0, **kw):
        seeds.append(seed)
        return orig(q, k, theta, seed=seed, **kw)

    monkeypatch.setattr(ttg, "graph_adjacency", spy)
    model, _ = create_visual_model(c)
    state = create_pretrain_state(c, model, "cpu")
    step = make_moco_step(float(c.CONTRAST.NCE_T), float(c.CONTRAST.ALPHA))
    clips = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, 2, T, H, W, 3)).astype(np.float32))
    for _ in range(2):
        step(state, clips, 0.1)
    assert len(seeds) == 4                       # (key, query) x 2 steps
    assert seeds[0] == seeds[1] and seeds[2] == seeds[3] and seeds[0] != seeds[2]
