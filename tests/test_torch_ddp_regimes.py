"""The port's SimSiam and memory-bank steps across ranks, on the CPU (gloo;
ranks are processes, ``tests/_torch_dist_util.py``).

* Two ranks (tiny3d + a graph block, sampler none, pre-augmented clips)
  against the JAX package's one-device ``make_pretrain_step`` on the global
  batch, three steps: loss, top-k, every parameter, the BN statistics (the
  SimSiam heads' included, which span the ranks) and the bank within the
  1e-4 rel-L2 of ``tests/test_torch_regimes.py`` (SimSiam at B = 8, as
  there; the bank at B = 4 with JAX's negative draw, each rank taking its
  rows of it).
* Two ranks of the fused step (raw uint8 clips; augmentation, graph noise
  of both SimSiam views and the bank's negatives drawn by the port) against
  the port's one-process fused step, three steps: each rank's draws are its
  rows of the one-process draws, so the two differ only in the order of
  their sums.  The bank holds the 1e-5 of ``tests/test_torch_ddp_step.py``;
  SimSiam, whose train-mode BN over 4 rows a rank and near-zero loss amplify
  that order past 1e-5, is held to the 1e-4 of its JAX comparison.  The ranks hold bit-equal states, the
  bank included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_util as du
from _torch_port_util import rel_l2
from test_torch_regimes import (B_SIMSIAM, ROUNDING_NOISE, ZERO_IN_EXACT_ARITHMETIC,
                                _jax_draw, assert_state_close)
from video_graph_ssl_tpu.engine import create_pretrain_state as jax_state
from video_graph_ssl_tpu.engine import make_pretrain_step
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
from video_graph_ssl_tpu_torch.engine.pretrain import make_fused_pretrain_step
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.utils.jax_weights import load_pretrain_weights

torch.set_num_threads(1)
T, H, W = 4, 16, 16
LRS = (0.1, 0.05, 0.1)
TOL_PORT = {"bank": 1e-5, "simsiam": 1e-4}


def _batch_size(mem_type):
    return B_SIMSIAM if mem_type == "simsiam" else 4


@pytest.mark.parametrize("mem_type", ["simsiam", "bank"])
def test_two_ranks_match_jax_single_device_step(tiny_cfg, tmp_path, mem_type):
    b = _batch_size(mem_type)
    c = tiny_cfg.clone()
    c.CONTRAST.MEM_TYPE = mem_type
    c.GRAPH.SAMPLER = "none"
    opts = ["CONTRAST.MEM_TYPE", mem_type, "GRAPH.SAMPLER", "none"]
    clips = np.random.default_rng(0).standard_normal((b, 2, T, H, W, 3)).astype(np.float32)
    jmodel, _ = jax_create(c)
    example = clips[:2] if mem_type == "simsiam" else clips[:2, 0]
    state, tx = jax_state(c, jmodel, jnp.asarray(example), n_data=du.N_DATA)
    model, _ = create_visual_model(du.port_cfg(opts))
    load_pretrain_weights(model, state.params, state.batch_stats, "tiny3d")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    memory = None if state.contrast is None else np.array(state.contrast.memory)

    jstep = jax.jit(make_pretrain_step(c, jmodel, tx, n_data=du.N_DATA))
    batch = {"clips": jnp.asarray(clips), "label": jnp.zeros((b,), jnp.int32),
             "index": jnp.arange(b, dtype=jnp.int32)}
    jm, draws = [], None
    if mem_type == "bank":
        draws = []
    for lr in LRS:
        if draws is not None:
            draws.append(_jax_draw(state, int(c.CONTRAST.NCE_K), b))
        state, m = jstep(state, batch, lr)
        jm.append({k: float(v) for k, v in m.items()})
    ranks = du.run_ranks(du.regime_worker, 2, tmp_path, opts, sd, memory, clips,
                         np.arange(b), LRS, draws)
    _assert_ranks_equal(ranks)
    got = ranks[0]
    for ours, ref in zip(got["metrics"], jm):
        assert sorted(ours) == sorted(ref)
        assert abs(ours["loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"])
        for k in ("top1", "top5"):
            if k in ref:
                assert ours[k] == pytest.approx(ref[k])
    st = got["state"]
    assert int(st["step"]) == int(state.step) == 3
    assert_state_close({k[len("model."):]: v for k, v in st.items() if k.startswith("model.")},
                       state)
    assert not any(k.startswith(("ema.", "queue")) for k in st)
    if mem_type == "bank":
        assert rel_l2(st["memory"], state.contrast.memory) < 1e-4
    else:
        assert "memory" not in st


def _assert_ranks_equal(ranks):
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


@pytest.mark.parametrize("mem_type", ["simsiam", "bank"])
def test_two_ranks_match_the_one_process_fused_step(tmp_path, mem_type):
    b = _batch_size(mem_type)
    opts = ["CONTRAST.MEM_TYPE", mem_type]
    clips = np.random.default_rng(1).integers(0, 256, (b, 2, T, 20, 20, 3), np.uint8)
    index = np.random.default_rng(2).permutation(du.N_DATA)[:b]
    ranks = du.run_ranks(du.regime_worker, 2, tmp_path, opts, None, None, clips, index,
                         LRS, None, True)
    c = du.port_cfg(opts)
    model, _ = create_visual_model(c)
    state = create_pretrain_state(c, model, "cpu", n_data=du.N_DATA)
    step = make_fused_pretrain_step(c)
    metrics = [{k: float(v) for k, v in step(state, torch.from_numpy(clips), lr,
                                              torch.from_numpy(index)).items()}
               for lr in LRS]
    one = du.state_arrays(state)
    _assert_ranks_equal(ranks)
    for ours, ref in zip(ranks[0]["metrics"], metrics):
        assert abs(ours["loss"] - ref["loss"]) <= TOL_PORT[mem_type] * abs(ref["loss"])
    assert sorted(ranks[0]["state"]) == sorted(one)
    for k, v in one.items():
        if k.endswith(ZERO_IN_EXACT_ARITHMETIC):
            assert max(np.abs(ranks[0]["state"][k]).max(), np.abs(v).max()) < ROUNDING_NOISE
        else:
            assert rel_l2(ranks[0]["state"][k], v) < TOL_PORT[mem_type], k
    if mem_type == "bank":   # the clips' rows moved, the others did not
        fresh = create_pretrain_state(c, create_visual_model(c)[0], "cpu",
                                      n_data=du.N_DATA).contrast.memory.numpy()
        moved = ~np.all(one["memory"] == fresh, axis=1)
        np.testing.assert_array_equal(np.flatnonzero(moved), np.sort(index))
