"""The port's downstream steps against the JAX package on the CPU, fp32
(tiny3d, B = 4, 4x16x16 clips, 8 classes).

* Lockstep: one shared initial state (the JAX ``VideoModel``'s init carried
  through the weight bridge), one pre-augmented batch, three steps of each
  package's ``make_downstream_train_step``: fine-tune with the graph off,
  fine-tune with the graph on (``GRAPH.SAMPLER none``: graph noise is not
  shared across packages), the linear probe under ``PROBE_BN eval`` and
  under ``PROBE_BN reference``; ``DROPOUT 0`` (dropout draws are not shared
  either; ``test_torch_downstream_models.py`` holds the port's dropout to
  its rate and scale).  Losses, top-k, every parameter and the BN
  statistics agree to 1e-4 (rel-L2 per tensor); the probe's encoder is bit
  for bit unchanged and takes no gradient.
* The eval and feature steps against JAX's ``make_eval_step`` and
  ``make_feature_step``.
* A JAX downstream ``.msgpack`` (2 steps of JAX's trainer step), read with
  flax and carried by ``downstream_state_from_jax``, takes the port's step 3
  to JAX's step 3 within 1e-4, fine-tune and probe.
* The fused step's augmentation is drawn from the step's own stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_port_util import np_tree, rel_l2
from video_graph_ssl_tpu.engine import create_downstream_state as jax_state
from video_graph_ssl_tpu.engine.downstream import make_downstream_train_step as jax_step
from video_graph_ssl_tpu.engine.downstream import make_eval_step as jax_eval_step
from video_graph_ssl_tpu.engine.downstream import make_feature_step as jax_feature_step
from video_graph_ssl_tpu.models import create_video_model as jax_create
from video_graph_ssl_tpu.utils import save_checkpoint_state as jax_save
from video_graph_ssl_tpu_torch.data import transforms_device as ttd
from video_graph_ssl_tpu_torch.engine.build import create_downstream_state
from video_graph_ssl_tpu_torch.engine.downstream import (TRAIN_AUGMENT_STREAM,
                                                         make_downstream_train_step,
                                                         make_eval_step, make_feature_step,
                                                         make_fused_downstream_step)
from video_graph_ssl_tpu_torch.models.build import create_video_model
from video_graph_ssl_tpu_torch.train_ds import bn_train_of
from video_graph_ssl_tpu_torch.utils.jax_weights import (downstream_state_dict,
                                                         downstream_state_from_jax,
                                                         load_downstream_weights)

torch.set_num_threads(1)
B, T, H, W = 4, 4, 16, 16
LRS = (0.1, 0.05, 0.1)
TOL = 1e-4
CASES = {"finetune": (False, "eval", False), "finetune_graph": (False, "eval", True),
         "probe_eval": (True, "eval", True), "probe_reference": (True, "reference", True)}


def _cfg(tiny_cfg, case):
    probe, probe_bn, graph = CASES[case]
    c = tiny_cfg.clone()
    c.MODEL.AUG_FLAG = graph
    c.MODEL.LINEAR_PROBE = probe
    c.MODEL.PROBE_BN = probe_bn
    c.GRAPH.SAMPLER = "none"
    return c


def _batch(seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((B, T, H, W, 3)).astype(np.float32),
            g.integers(0, 8, B).astype(np.int32))


def _jax_init(c, clips):
    jmodel, _ = jax_create(c)
    state, tx = jax_state(c, jmodel, jnp.asarray(clips[:2]))
    return jmodel, state, tx


def _port_state(c, state):
    model, _ = create_video_model(c)
    load_downstream_weights(model, np_tree(state.params), np_tree(state.batch_stats))
    return create_downstream_state(c, model, "cpu")


def assert_state_close(tstate, state, tol=TOL):
    ref = downstream_state_dict(np_tree(state.params), np_tree(state.batch_stats), "tiny3d")
    ours = {k: v.detach().numpy() for k, v in tstate.model.state_dict().items()}
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert rel_l2(ours[k], ref[k]) < tol, k
    assert tstate.step == int(state.step)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_lockstep_with_jax(tiny_cfg, case):
    c = _cfg(tiny_cfg, case)
    bn_train = bn_train_of(c)
    clips, labels = _batch()
    jmodel, state, tx = _jax_init(c, clips)
    jstep = jax.jit(jax_step(jmodel, tx, bn_train))
    tstate = _port_state(c, state)
    tstep = make_downstream_train_step(bn_train)
    enc0 = {k: v.clone() for k, v in tstate.model.state_dict().items()
            if not k.startswith("new_fc")}
    fc0 = tstate.model.new_fc.weight.detach().clone()
    batch = {"clips": jnp.asarray(clips), "label": jnp.asarray(labels)}
    for lr in LRS:
        state, jm = jstep(state, batch, lr)
        tm = tstep(tstate, torch.from_numpy(clips), torch.from_numpy(labels), lr)
        assert sorted(tm) == sorted(jm) == ["loss", "top1", "top5"]
        assert np.isfinite(float(jm["loss"]))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
        for k in ("top1", "top5"):
            assert float(tm[k]) == pytest.approx(float(jm[k]))
    assert_state_close(tstate, state)
    assert not torch.equal(tstate.model.new_fc.weight, fc0)
    after = tstate.model.state_dict()
    moved = sorted(k for k, v in enc0.items() if not torch.equal(v, after[k]))
    if case.startswith("probe"):
        held = [n for n, p in tstate.model.named_parameters() if not n.startswith("new_fc")]
        assert all(tstate.model.get_parameter(n).grad is None for n in held)
        opt_params = {id(p) for g in tstate.optimizer.param_groups for p in g["params"]}
        assert opt_params == {id(tstate.model.new_fc.weight), id(tstate.model.new_fc.bias)}
        # the encoder bit for bit: parameters always, statistics but for
        # stage0's (the live BN of the reference's partial-BN train mode)
        live = ["base_model.stage0.bn.running_mean", "base_model.stage0.bn.running_var"]
        assert moved == (live if case == "probe_reference" else [])
    else:
        assert any(k.endswith("weight") for k in moved)


def test_eval_and_feature_steps_match_jax(tiny_cfg):
    c = _cfg(tiny_cfg, "finetune_graph")
    clips, _ = _batch(1)
    jmodel, state, _ = _jax_init(c, clips)
    tstate = _port_state(c, state)
    x = torch.from_numpy(clips)
    logits = make_eval_step()(tstate.model, x)
    feats = make_feature_step()(tstate.model, x)
    assert not logits.requires_grad and not tstate.model.training
    assert rel_l2(logits.numpy(), jax_eval_step(jmodel)(state, jnp.asarray(clips))) < 1e-5
    assert rel_l2(feats.numpy(), jax_feature_step(jmodel)(state, jnp.asarray(clips))) < 1e-5


@pytest.mark.parametrize("case", ["finetune_graph", "probe_eval"])
def test_jax_checkpoint_continues_in_the_port(tiny_cfg, tmp_path, case):
    c = _cfg(tiny_cfg, case)
    bn_train = bn_train_of(c)
    clips, labels = _batch(2)
    jmodel, state, tx = _jax_init(c, clips)
    jstep = jax.jit(jax_step(jmodel, tx, bn_train))
    batch = {"clips": jnp.asarray(clips), "label": jnp.asarray(labels)}
    for lr in LRS[:2]:
        state, _ = jstep(state, batch, lr)
    path = str(tmp_path / "ds.msgpack")
    jax_save(path, state, epoch=1)
    with open(path, "rb") as f:
        tree = serialization.msgpack_restore(f.read())["state"]
    model, _ = create_video_model(c, seed=9)
    tstate = create_downstream_state(c, model, "cpu")
    downstream_state_from_jax(tree, tstate)
    assert tstate.step == 2
    state, jm = jstep(state, batch, LRS[2])
    tm = make_downstream_train_step(bn_train)(tstate, torch.from_numpy(clips),
                                              torch.from_numpy(labels), LRS[2])
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
    assert_state_close(tstate, state)


def test_fused_step_draws_from_its_own_stream(tiny_cfg):
    c = _cfg(tiny_cfg, "finetune")
    g = np.random.default_rng(3)
    raw = torch.from_numpy(g.integers(0, 256, (B, T, 20, 20, 3), dtype=np.uint8))
    labels = torch.from_numpy(g.integers(0, 8, B))
    a = create_downstream_state(c, create_video_model(c)[0], "cpu")
    b = create_downstream_state(c, create_video_model(c)[0], "cpu")
    fused = make_fused_downstream_step(c)
    inner = make_downstream_train_step()
    augment = ttd.make_batch_augment_fn(c, "train")
    for lr in LRS:
        gen = torch.Generator().manual_seed(b.step_seed(TRAIN_AUGMENT_STREAM))
        mb = inner(b, augment(gen, raw), labels, lr)
        ma = fused(a, raw, labels, lr)
        assert torch.equal(ma["loss"], mb["loss"])
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert a.step == 3


@pytest.mark.parametrize("mem_type,kw,want", [
    ("finetune", dict(partial_bn=True, graph=False), (0, 0, 9, 4, 0)),
    ("finetune", dict(partial_bn=True), (3, 6, 9, 4, 0)),
    ("finetune", dict(fused=True, partial_bn=True), (3, 6, 9, 4, 0)),
    ("finetune", dict(fused=True, graph=False), (0, 0, 9, 4, 18)),
    ("probe", dict(partial_bn=True), (3, 3, 0, 0, 0)),
    ("probe", dict(fused=True, graph=False), (0, 0, 0, 0, 0)),
    ("eval", dict(), (3, 3, 0, 0, 0)),
])
def test_step_calls_of_the_downstream_steps(mem_type, kw, want):
    """K1-K5 wrapper calls per step, as chip_smoke.py holds the card's
    counts: a fine-tune step is one pass and one backward, the probe and
    the eval forward one pass; partial BN takes every pair off K5."""
    from video_graph_ssl_tpu_torch.kernel_times import step_calls

    calls = step_calls(mem_type, **kw)
    assert tuple(calls.values()) == want
    assert list(calls) == ["graph_adjacency", "gcn_propagate", "maxpool_bwd_s1",
                           "maxpool_bwd_strided", "sepconv_bwd"]
