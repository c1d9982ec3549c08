"""The port's CMC steps (``CROSS.MODALITY cross``, MoCo and bank) against the
JAX package's jitted ``make_pretrain_step`` on the CPU, fp32 (tiny3d + its
graph block, ``GRAPH.SAMPLER none``, B = 4, 4x16x16 clips).

* Lockstep: one shared initial state (JAX's init carried into the port
  through the weight bridge, both queues or both banks copied), one
  pre-augmented batch, three steps.  Loss and top-k, every parameter and BN
  statistic of both stacks (the EMA stacks for MoCo), both queues and the
  pointer, or both memories, within 1e-4 (rel-L2 per tensor).  The bank
  takes JAX's negative draw of each step, injected, under ``crossentropy``
  and under ``NCE``, at the schema's ``CONTRAST.NCE_T`` 0.07; the NCE case
  scores at T = 2.5 with each clip's rows started at the other modality's
  initial feature, so that its scores stay in the loss's domain (see
  ``tests/test_torch_regimes.py``).
* The cases of JAX's ``tests/test_cmc.py`` on the port's steps: the MoCo
  step moves both queues and the one pointer and lowers the summed loss on
  one batch; the bank step moves the batch's rows of both memories and no
  other.
* A JAX CMC ``.msgpack`` (two steps) resumed in the port: its step 3 lands
  on JAX's within 1e-4, MoCo and bank.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_port_util import rel_l2
from test_torch_cmc import cmc_cfg
from video_graph_ssl_tpu.engine import create_pretrain_state as jax_state
from video_graph_ssl_tpu.engine import make_pretrain_step as jax_make_step
from video_graph_ssl_tpu.memory import bank as jbank
from video_graph_ssl_tpu.utils import save_checkpoint_state as jax_save
from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
from video_graph_ssl_tpu_torch.engine.pretrain import make_cmc_bank_step, make_pretrain_step
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.solver.build import grad_clip_norm
from video_graph_ssl_tpu_torch.utils.jax_weights import (load_pretrain_weights,
                                                         pretrain_state_dict,
                                                         pretrain_state_from_jax)

torch.set_num_threads(1)
B, T, H, W = 4, 4, 16, 16
N_DATA = 32
LRS = (0.1, 0.05, 0.1)
TOL = 1e-4
NCE_T = 2.5


def _cfg(mem_type, criterion="crossentropy"):
    c = cmc_cfg(mem_type=mem_type)
    c.CROSS.CRITERION = criterion
    if criterion == "NCE":
        c.CONTRAST.NCE_T = NCE_T
    return c


def _clips(seed=0):
    return np.random.default_rng(seed).standard_normal((B, 2, T, H, W, 3)).astype(np.float32)


def _batch(clips):
    return {"clips": jnp.asarray(clips), "label": jnp.zeros((B,), jnp.int32),
            "index": jnp.arange(B, dtype=jnp.int32)}


def _jax_init(c, clips):
    from video_graph_ssl_tpu.models import create_visual_model as jax_create

    jmodel, _ = jax_create(c)
    state, tx = jax_state(c, jmodel, jnp.asarray(clips[:2, 0]), n_data=N_DATA)
    return jmodel, state, tx


def _copy_memory(tstate, contrast) -> None:
    for name in ("queue_1", "queue_2", "memory_1", "memory_2"):
        if hasattr(contrast, name):
            getattr(tstate.contrast, name).copy_(
                torch.from_numpy(np.array(getattr(contrast, name))))


def _port_state(c, state):
    model, _ = create_visual_model(c)
    load_pretrain_weights(model, state.params, state.batch_stats, "tiny3d")
    tstate = create_pretrain_state(c, model, "cpu", n_data=N_DATA)
    _copy_memory(tstate, state.contrast)
    return tstate


def _jax_draw(state, K=16):
    """JAX's negative draw of the bank step at ``state.step`` (NCE_K 16)."""
    key = jax.random.fold_in(jax.random.fold_in(state.rng, state.step), 7)
    return np.asarray(jax.random.randint(key, (B, K + 1), 0, N_DATA), np.int64)


def _tstep(c, draws=None):
    if c.CONTRAST.MEM_TYPE == "bank":
        return make_cmc_bank_step(int(c.CONTRAST.NCE_K), float(c.CONTRAST.NCE_T),
                                  float(c.CONTRAST.NCE_M), c.CROSS.CRITERION,
                                  grad_clip_norm(c),
                                  draw=lambda st, *a: torch.from_numpy(draws[st.step]))
    return make_pretrain_step(c)


def assert_cmc_state_close(tstate, state, tol=TOL):
    """Both stacks' parameters and BN statistics (and the EMA stacks'),
    both queues and the pointer or both memories, and the step."""
    pairs = [(tstate.model, state.params, state.batch_stats)]
    if tstate.ema_model is not None:
        pairs.append((tstate.ema_model, state.ema_params, state.ema_batch_stats))
    for port, params, stats in pairs:
        ref = pretrain_state_dict(params, stats, "tiny3d")
        ours = {k: v.detach().numpy() for k, v in port.state_dict().items()}
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert rel_l2(ours[k], ref[k]) < tol, k
    for name in ("queue_1", "queue_2", "memory_1", "memory_2"):
        if hasattr(state.contrast, name):
            assert rel_l2(getattr(tstate.contrast, name).numpy(),
                          getattr(state.contrast, name)) < tol, name
    if hasattr(state.contrast, "ptr"):
        assert tstate.contrast.ptr == int(state.contrast.ptr)
    assert tstate.step == int(state.step)


def _banks_at_features(tstate, state, clips):
    """Both banks' rows 0..B-1 at the other modality's initial features (a
    copy of the port's model in train mode): ``x1`` scores against
    ``memory_2``, ``x2`` against ``memory_1``, so the positives start above
    0 and every score stays in the NCE loss's domain."""
    model = copy.deepcopy(tstate.model).train()
    with torch.no_grad():
        f1, f2 = (f.numpy() for f in model(torch.from_numpy(clips[:, 0]),
                                           graph_seed=(0, 1)))
    m1, m2 = np.array(state.contrast.memory_1), np.array(state.contrast.memory_2)
    m1[:B], m2[:B] = f2, f1
    contrast = jbank.CmcBankState(memory_1=jnp.asarray(m1), memory_2=jnp.asarray(m2))
    _copy_memory(tstate, contrast)
    return state.replace(contrast=contrast)


@pytest.mark.parametrize("mem_type,criterion", [("moco", "crossentropy"),
                                                ("bank", "crossentropy"),
                                                ("bank", "NCE")])
def test_cmc_step_lockstep_with_jax(mem_type, criterion):
    c = _cfg(mem_type, criterion)
    clips = _clips()
    jmodel, state, tx = _jax_init(c, clips)
    jstep = jax.jit(jax_make_step(c, jmodel, tx, n_data=N_DATA))
    tstate = _port_state(c, state)
    if criterion == "NCE":
        state = _banks_at_features(tstate, state, clips)
    draws = {}
    tstep = _tstep(c, draws)
    for lr in LRS:
        draws[tstate.step] = _jax_draw(state)
        state, jm = jstep(state, _batch(clips), lr)
        tm = tstep(tstate, torch.from_numpy(clips), lr, torch.arange(B))
        assert sorted(tm) == sorted(jm) == ["loss", "top1", "top5"]
        assert np.isfinite(float(jm["loss"]))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
        for k in ("top1", "top5"):
            assert float(tm[k]) == pytest.approx(float(jm[k]))
    assert_cmc_state_close(tstate, state)
    if mem_type == "moco":
        assert tstate.contrast.ptr == 3 * B


def test_jax_cmc_moco_step_cases():
    """JAX test_cmc_moco_step on the port: three steps at lr 0.5 on one
    batch move both queues' first 3 B rows, the one pointer to 3 B, and
    lower the summed InfoNCE loss."""
    c = cmc_cfg(mem_type="moco")
    model, _ = create_visual_model(c)
    state = create_pretrain_state(c, model, "cpu")
    q1, q2 = state.contrast.queue_1.clone(), state.contrast.queue_2.clone()
    step = make_pretrain_step(c)
    clips = torch.from_numpy(_clips())
    losses = [float(step(state, clips, 0.5)["loss"]) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert state.contrast.ptr == 3 * B
    assert not torch.allclose(q1[:B], state.contrast.queue_1[:B])
    assert not torch.allclose(q2[:B], state.contrast.queue_2[:B])
    torch.testing.assert_close(state.contrast.queue_1[3 * B:], q1[3 * B:], rtol=0, atol=0)


def test_jax_cmc_bank_step_cases():
    """JAX test_cmc_bank_step on the port: one step moves the batch's rows
    of both memories and no other."""
    c = cmc_cfg(mem_type="bank")
    model, _ = create_visual_model(c)
    state = create_pretrain_state(c, model, "cpu", n_data=N_DATA)
    m1, m2 = state.contrast.memory_1.clone(), state.contrast.memory_2.clone()
    metrics = make_pretrain_step(c)(state, torch.from_numpy(_clips()), 0.1, torch.arange(B))
    assert np.isfinite(float(metrics["loss"]))
    for before, after in ((m1, state.contrast.memory_1), (m2, state.contrast.memory_2)):
        assert not torch.allclose(before[:B], after[:B])
        torch.testing.assert_close(before[B:], after[B:], rtol=0, atol=0)


@pytest.mark.parametrize("mem_type", ["moco", "bank"])
def test_jax_cmc_checkpoint_resumes_in_the_port(tmp_path, mem_type):
    """JAX trains 2 CMC steps and writes its ``.msgpack``; the port reads it
    with ``pretrain_state_from_jax`` (both stacks, the EMA stacks, the
    momentum traces, both queues and the pointer or both banks) and its
    step 3 lands on JAX's."""
    c = _cfg(mem_type)
    clips = _clips(12)
    jmodel, state, tx = _jax_init(c, clips)
    jstep = jax.jit(jax_make_step(c, jmodel, tx, n_data=N_DATA))
    for lr in (0.1, 0.05):
        state, _ = jstep(state, _batch(clips), lr)
    path = str(tmp_path / "jax.msgpack")
    jax_save(path, state, epoch=1)
    with open(path, "rb") as f:
        tree = serialization.msgpack_restore(f.read())["state"]
    assert set(tree["params"]) == {"model_1", "model_2"}
    model, _ = create_visual_model(c, seed=5)
    tstate = create_pretrain_state(c, model, "cpu", n_data=N_DATA)
    pretrain_state_from_jax(tree, tstate)
    assert tstate.step == 2
    assert_cmc_state_close(tstate, state, tol=1e-7)
    draws = {2: _jax_draw(state)}
    state, jm = jstep(state, _batch(clips), 0.1)
    tm = _tstep(c, draws)(tstate, torch.from_numpy(clips), 0.1, torch.arange(B))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
    assert_cmc_state_close(tstate, state)
