"""The port's GCA MoCo step and trainer across ranks, on the CPU (gloo; ranks
are processes, ``tests/_torch_dist_util.py``).

* Two ranks (tiny3d + a graph block, B = 4 global, 2 rows each, sampler
  none, pre-augmented clips) against the JAX package's one-device
  ``make_moco_step`` on the global batch: three steps in lockstep at the
  1e-4 rel-L2 of ``tests/test_torch_moco_step.py``, on loss, params, EMA,
  BN statistics, queue and pointer.
* Two ranks of the fused step (raw uint8 clips, augmentation and graph
  noise drawn, sampler on) against the port's one-process fused step, three
  steps, fp32: 1e-5 rel-L2 per tensor, the loss to 1e-5 (the ranks sum BN
  statistics, gradients and features in another order than one process).
  The ranks hold bit-equal states.
* One rank in a group is the no-group step, bit for bit.
* ShuffleBN: two ranks with an injected permutation take three finite steps
  and hold bit-equal states; its key pass is held to JAX's in
  ``tests/test_torch_parallel.py``.
* ``TPU.SEPCONV_FUSED True`` at world size 2 raises, naming the ROADMAP item,
  before any BN runs; at world size 1 it builds.
* The trainer's CLI as two gloo ranks (``--device cpu --dist-backend gloo
  --world_size 2 --rank R --dist-url file://...``), 2 steps: only rank 0
  writes, one checkpoint, and it equals the one-process CLI's to 1e-5.
  Its other launchers, torchrun's environment and the reference's
  ``--multiprocessing-distributed``, each start one gloo rank that trains.
"""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_util as du
from _torch_port_util import rel_l2
from video_graph_ssl_tpu.engine import create_pretrain_state as jax_state
from video_graph_ssl_tpu.engine import make_pretrain_step
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
from video_graph_ssl_tpu_torch.engine.pretrain import make_fused_pretrain_step
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.utils.jax_weights import (load_pretrain_weights,
                                                         pretrain_state_dict)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, H, W = 4, 4, 16, 16
LRS = (0.1, 0.05, 0.1)
TOL_PORT = 1e-5


def _raw_clips(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, 2, T, 20, 20, 3), np.uint8)


def _one_process(opts, clips, lrs=LRS):
    """The fused step in this process, no group; (metrics, state arrays)."""
    c = du.port_cfg(opts)
    model, _ = create_visual_model(c)
    state = create_pretrain_state(c, model, "cpu")
    step = make_fused_pretrain_step(c)
    metrics = [{k: float(v) for k, v in step(state, torch.from_numpy(clips), lr).items()}
               for lr in lrs]
    return metrics, du.state_arrays(state)


def _assert_ranks_equal(ranks):
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


def test_two_ranks_match_jax_single_device_step(tiny_cfg, tmp_path):
    c = tiny_cfg.clone()
    c.CONTRAST.MEM_TYPE = "moco"
    c.GRAPH.SAMPLER = "none"
    clips = np.random.default_rng(0).standard_normal((B, 2, T, H, W, 3)).astype(np.float32)
    jmodel, _ = jax_create(c)
    state, tx = jax_state(c, jmodel, jnp.asarray(clips[:2, 0]), n_data=32)
    model, _ = create_visual_model(du.port_cfg(["GRAPH.SAMPLER", "none"]))
    load_pretrain_weights(model, state.params, state.batch_stats, "tiny3d")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    queue = np.array(state.contrast.queue)
    ranks = du.run_ranks(du.step_worker, 2, tmp_path, ["GRAPH.SAMPLER", "none"], sd,
                         queue, clips, LRS, False)

    jstep = jax.jit(make_pretrain_step(c, jmodel, tx))
    batch = {"clips": jnp.asarray(clips), "label": jnp.zeros((B,), jnp.int32),
             "index": jnp.arange(B, dtype=jnp.int32)}
    jm = []
    for lr in LRS:
        state, m = jstep(state, batch, lr)
        jm.append({k: float(v) for k, v in m.items()})
    _assert_ranks_equal(ranks)
    got = ranks[0]
    for ours, ref in zip(got["metrics"], jm):
        assert abs(ours["loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"])
        for k in ("top1", "top5"):
            assert ours[k] == pytest.approx(ref[k])
    st = got["state"]
    assert int(st["step"]) == int(state.step) == 3
    assert int(st["ptr"]) == int(state.contrast.ptr) == (B * 3) % 16
    assert rel_l2(st["queue"], state.contrast.queue) < 1e-4
    for tag, params, stats in (("model", state.params, state.batch_stats),
                               ("ema", state.ema_params, state.ema_batch_stats)):
        ref = pretrain_state_dict(params, stats, "tiny3d")
        assert sorted(k for k in st if k.startswith(tag + ".")) == sorted(
            f"{tag}.{k}" for k in ref)
        for k, v in ref.items():
            assert rel_l2(st[f"{tag}.{k}"], v) < 1e-4, f"{tag}.{k}"


def test_two_ranks_match_the_one_process_fused_step(tmp_path):
    """Sampler on: each rank's augmentation and graph noise are its rows of
    the one-process draws."""
    clips = _raw_clips()
    ranks = du.run_ranks(du.step_worker, 2, tmp_path, [], None, None, clips, LRS, True)
    metrics, state = _one_process([], clips)
    _assert_ranks_equal(ranks)
    for ours, ref in zip(ranks[0]["metrics"], metrics):
        assert abs(ours["loss"] - ref["loss"]) <= TOL_PORT * abs(ref["loss"])
    for k, v in state.items():
        assert rel_l2(ranks[0]["state"][k], v) < TOL_PORT, k
    # the EMA moved and the queue took 3 x 4 keys
    assert int(ranks[0]["state"]["ptr"]) == 12


def test_one_rank_in_a_group_is_the_no_group_step_bit_for_bit(tmp_path):
    clips = _raw_clips(1)
    (rank,) = du.run_ranks(du.step_worker, 1, tmp_path, [], None, None, clips, LRS, True)
    metrics, state = _one_process([], clips)
    assert rank["metrics"] == metrics
    for k, v in state.items():
        np.testing.assert_array_equal(rank["state"][k], v, err_msg=k)


def test_shuffle_bn_step_on_two_ranks(tmp_path):
    clips = np.random.default_rng(2).standard_normal((B, 2, T, H, W, 3)).astype(np.float32)
    ranks = du.run_ranks(du.step_worker, 2, tmp_path, [], None, None, clips, LRS, False,
                         np.array([3, 1, 0, 2]))
    _assert_ranks_equal(ranks)
    assert all(np.isfinite(m["loss"]) for m in ranks[0]["metrics"])
    assert int(ranks[0]["state"]["ptr"]) == 12


@pytest.mark.parametrize("world", [1, 2])
def test_sepconv_fused_across_ranks_raises(tmp_path, world):
    ranks = du.run_ranks(du.fused_guard_worker, world, tmp_path)
    for r in ranks:
        if world == 1:
            assert r["builder"] is None and r["layer"] is None
        else:
            for msg in (r["builder"], r["layer"]):
                assert msg is not None and "ROADMAP.md" in msg and "K5 across ranks" in msg
            # raised before the pair's BN ran
            np.testing.assert_array_equal(r["running_mean"], np.zeros(8, np.float32))


TRAIN = ["MODEL.BACKBONE", "tiny3d", "MODEL.AUG_FLAG", "True", "DATASET.NUM_CLASS", "4",
         "DATALOADER.BATCH_SIZE", "4", "DATALOADER.NUM_WORKERS", "2",
         "INPUT.VIDEO_LENGTH", "4", "INPUT.SCALE_SIZE", "[20, 20]",
         "INPUT.BASE_SIZE", "[16, 16]", "CONTRAST.NCE_K", "16", "CROSS.FEAT_DIM", "32",
         "CHECKPOINT.PRINT_FREQ", "1", "DATASET.SOURCE", "synthetic",
         "SOLVER.MAX_EPOCHS", "1", "TPU.COMPUTE_DTYPE", "float32"]


def _cli(cwd, extra, **env_vars):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **env_vars)
    return subprocess.Popen(
        [sys.executable, "-m", "video_graph_ssl_tpu_torch.train_video_contrast_dis",
         "--config_file", os.path.join(REPO, "configs", "visual_moco.yaml"),
         "--device", "cpu", "--max_steps", "2", *extra, *TRAIN],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_trainer_cli_on_two_ranks(tmp_path):
    ranks_dir, one_dir = tmp_path / "ranks", tmp_path / "one"
    ranks_dir.mkdir()
    one_dir.mkdir()
    url = "file://" + str(tmp_path / "rendezvous")
    procs = [_cli(ranks_dir, ["--dist-backend", "gloo", "--world_size", "2", "--rank",
                              str(r), "--dist-url", url]) for r in range(2)]
    procs.append(_cli(one_dir, []))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], "\n".join(o[-3000:] for o in outs)
    # rank 0 logs, rank 1 is silent
    assert outs[0].count("Epoch: [0]") == 2 and "Epoch:" not in outs[1]
    written = sorted(glob.glob(str(ranks_dir / "run" / "**" / "*.pth.tar"), recursive=True))
    assert len(written) == 1 and written[0].endswith("experiment_00/checkpoint_1.pth.tar")
    (ref,) = glob.glob(str(one_dir / "run" / "**" / "checkpoint_1.pth.tar"), recursive=True)
    a = torch.load(written[0], weights_only=True)
    b = torch.load(ref, weights_only=True)
    assert a["step"] == b["step"] == 2 and a["contrast"]["ptr"] == b["contrast"]["ptr"] == 8
    for part in ("state_dict", "model_ema"):
        for k, v in b[part].items():
            assert rel_l2(a[part][k].numpy(), v.numpy()) < TOL_PORT, f"{part}.{k}"
    assert rel_l2(a["contrast"]["queue"].numpy(), b["contrast"]["queue"].numpy()) < TOL_PORT


@pytest.mark.parametrize("launcher", ["torchrun", "multiprocessing-distributed"])
def test_trainer_cli_launchers(tmp_path, launcher):
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    if launcher == "torchrun":
        proc = _cli(tmp_path, ["--dist-backend", "gloo"], RANK="0", LOCAL_RANK="0",
                    WORLD_SIZE="1", MASTER_ADDR="localhost", MASTER_PORT=port)
    else:
        proc = _cli(tmp_path, ["--dist-backend", "gloo", "--multiprocessing-distributed"])
    out = proc.communicate(timeout=240)[0]
    assert proc.returncode == 0, out[-3000:]
    assert out.count("Epoch: [0]") == 2
    assert glob.glob(str(tmp_path / "run" / "**" / "checkpoint_1.pth.tar"), recursive=True)
