"""The port's checkpoints on the CPU, at tiny3d.

* Round trip: a checkpoint written by ``save_checkpoint_state`` and loaded
  into a fresh state gives the saved state bit for bit (parameters, BN
  statistics, EMA, momentum buffers, queue, pointer, step, seed).
* Resume: a straight run equals a checkpoint-and-resume run bit for bit
  (the fused step with its augmentation and graph draws), as
  ``tests/test_checkpoint.py`` holds the JAX package.
* From JAX: the JAX package trains 2 steps and writes its ``.msgpack``;
  the state, read with flax and converted by ``pretrain_state_from_jax``,
  takes the port's step 3 to JAX's step 3 within 1e-4 (rel-L2 per tensor),
  with the pre-augmented clips and ``GRAPH.SAMPLER none`` of
  ``tests/test_torch_moco_step.py``.  The bias momentum traces are divided
  by ``SOLVER.BIAS_LR_FACTOR`` on the way.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_port_util import rel_l2
from video_graph_ssl_tpu.engine import create_pretrain_state as jax_state
from video_graph_ssl_tpu.engine import make_pretrain_step
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu.utils import save_checkpoint_state as jax_save
from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
from video_graph_ssl_tpu_torch.engine.pretrain import make_fused_pretrain_step, make_moco_step
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.solver.build import label_params
from video_graph_ssl_tpu_torch.utils.checkpoint import (checkpoint_payload,
                                                        load_checkpoint_state,
                                                        mismatches,
                                                        save_checkpoint_state)
from video_graph_ssl_tpu_torch.utils.jax_weights import (pretrain_state_dict,
                                                         pretrain_state_from_jax)

torch.set_num_threads(1)
B, T, H, W = 4, 4, 16, 16


def _cfg(tiny_cfg):
    c = tiny_cfg.clone()
    c.CONTRAST.MEM_TYPE = "moco"
    return c


def _state(c, seed=None):
    model, _ = create_visual_model(c, seed=seed)
    return create_pretrain_state(c, model, "cpu")


def _raw_clips(n, seed=0):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.integers(0, 256, (B, 2, T, 20, 20, 3), dtype=np.uint8))
            for _ in range(n)]


def test_round_trip_is_bit_exact(tiny_cfg, tmp_path):
    c = _cfg(tiny_cfg)
    state = _state(c)
    step = make_fused_pretrain_step(c)
    for clips in _raw_clips(2):
        step(state, clips, 0.1)
    path = str(tmp_path / "ckpt.pth.tar")
    save_checkpoint_state(path, state, epoch=3, best_pred=1.5, extra={"note": "x"})
    fresh = _state(c, seed=99)
    assert mismatches(checkpoint_payload(state, 3, 1.5), checkpoint_payload(fresh, 3, 1.5))
    meta = load_checkpoint_state(path, fresh)
    assert meta == {"epoch": 3, "best_pred": 1.5, "step": 2, "note": "x"}
    with open(path + ".meta.json") as f:
        assert json.load(f) == meta
    assert mismatches(checkpoint_payload(state, 3, 1.5),
                      checkpoint_payload(fresh, 3, 1.5)) == []
    assert len(fresh.optimizer.state) == len(list(state.model.parameters()))
    payload = torch.load(path, weights_only=True)
    assert {"epoch", "state_dict", "optimizer", "contrast", "model_ema", "best_pred",
            "step", "seed"} <= set(payload)


def test_resume_equals_straight_run(tiny_cfg, tmp_path):
    """4 steps straight == 2 steps, checkpoint, restore into a fresh state
    (other initial weights), 2 steps; bit for bit, graph and augmentation
    draws included."""
    c = _cfg(tiny_cfg)
    batches = _raw_clips(4, seed=1)
    lrs = (0.1, 0.1, 0.05, 0.05)
    step = make_fused_pretrain_step(c)
    straight = _state(c)
    for clips, lr in zip(batches, lrs):
        last = step(straight, clips, lr)

    first = _state(c)
    for clips, lr in zip(batches[:2], lrs[:2]):
        step(first, clips, lr)
    path = str(tmp_path / "mid.pth.tar")
    save_checkpoint_state(path, first, epoch=1)
    resumed = _state(c, seed=7)
    load_checkpoint_state(path, resumed)
    for clips, lr in zip(batches[2:], lrs[2:]):
        again = step(resumed, clips, lr)
    assert torch.equal(last["loss"], again["loss"])
    assert mismatches(checkpoint_payload(straight, 2), checkpoint_payload(resumed, 2)) == []


def _jax_two_steps(c, clips, tmp_path):
    jmodel, _ = jax_create(c)
    state, tx = jax_state(c, jmodel, jnp.asarray(clips[:2, 0]), n_data=32)
    jstep = jax.jit(make_pretrain_step(c, jmodel, tx))
    batch = {"clips": jnp.asarray(clips), "label": jnp.zeros((B,), jnp.int32),
             "index": jnp.arange(B, dtype=jnp.int32)}
    for lr in (0.1, 0.05):
        state, _ = jstep(state, batch, lr)
    path = str(tmp_path / "jax.msgpack")
    jax_save(path, state, epoch=1)
    return state, jstep, batch, path


def _read_msgpack(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())["state"]


def test_jax_checkpoint_resumes_in_the_port(tiny_cfg, tmp_path):
    c = _cfg(tiny_cfg)
    c.GRAPH.SAMPLER = "none"
    clips = np.random.default_rng(0).standard_normal((B, 2, T, H, W, 3)).astype(np.float32)
    state, jstep, batch, path = _jax_two_steps(c, clips, tmp_path)
    tree = _read_msgpack(path)

    tstate = _state(c, seed=5)
    pretrain_state_from_jax(tree, tstate)
    assert tstate.step == 2 and tstate.contrast.ptr == int(tree["contrast"]["ptr"])
    # the bias traces carry BIAS_LR_FACTOR, the port's buffers do not
    traces = pretrain_state_dict(
        next(v["trace"] for v in tree["opt_state"]["inner_state"].values()
             if "trace" in v), tree["batch_stats"], "tiny3d")
    labels = label_params(tstate.model)
    factor = float(c.SOLVER.BIAS_LR_FACTOR)
    assert factor != 1.0
    for name, p in tstate.model.named_parameters():
        want = traces[name] / (factor if labels[name] == "bias" else 1.0)
        np.testing.assert_array_equal(
            tstate.optimizer.state[p]["momentum_buffer"].numpy(), want.astype(np.float32))

    state, jm = jstep(state, batch, 0.1)
    tm = make_moco_step(float(c.CONTRAST.NCE_T), float(c.CONTRAST.ALPHA))(
        tstate, torch.from_numpy(clips), 0.1)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
    assert tstate.step == int(state.step) == 3
    assert tstate.contrast.ptr == int(state.contrast.ptr)
    assert rel_l2(tstate.contrast.queue.numpy(), state.contrast.queue) < 1e-4
    for name, (port, params, stats) in {
            "model": (tstate.model, state.params, state.batch_stats),
            "ema": (tstate.ema_model, state.ema_params, state.ema_batch_stats),
    }.items():
        ref = pretrain_state_dict(params, stats, "tiny3d")
        ours = {k: v.detach().numpy() for k, v in port.state_dict().items()}
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert rel_l2(ours[k], ref[k]) < 1e-4, f"{name}: {k}"


def test_jax_state_must_name_the_ports_parameters(tiny_cfg, tmp_path):
    """A JAX state of another shape of model is refused, not half loaded."""
    c = _cfg(tiny_cfg)
    c.GRAPH.SAMPLER = "none"
    clips = np.zeros((B, 2, T, H, W, 3), np.float32)
    jmodel, _ = jax_create(c)
    state, _ = jax_state(c, jmodel, jnp.asarray(clips[:2, 0]), n_data=32)
    path = str(tmp_path / "j.msgpack")
    jax_save(path, state, epoch=0)
    other = c.clone()
    other.CROSS.HEAD_TYPE = "linear" if c.CROSS.HEAD_TYPE != "linear" else "mlp"
    with pytest.raises(KeyError, match="does not name"):
        pretrain_state_from_jax(_read_msgpack(path), _state(other))
