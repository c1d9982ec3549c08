"""The port's downstream steps and tools across ranks, on the CPU (gloo; ranks
are processes, ``tests/_torch_dist_util.py``).  tiny3d with a graph block,
B = 4 global, 2 rows per rank.

* Two ranks of the fine-tune step (partial BN, graph on) and of the linear
  probe (``PROBE_BN eval`` and ``reference``), pre-augmented clips, against
  the JAX package's one-device ``make_downstream_train_step`` on the global
  batch: three steps at the 1e-4 rel-L2 of
  ``tests/test_torch_downstream_steps.py``, which also fixes the draws the
  packages cannot share (``GRAPH.SAMPLER none``, ``DROPOUT 0``).  The
  probe's encoder stays bit for bit.
* Two ranks of the fused step (raw uint8 clips, the ``train`` augmentation,
  graph noise and dropout 0.5 drawn) against the port's one-process fused
  step, fine-tune and probe: 1e-5 rel-L2 per tensor, the loss to 1e-5.  The
  ranks hold bit-equal states, and each rank's augmented clips are its rows
  of the one-process augmentation, bit for bit.
* One rank in a group is the no-group step, bit for bit.
* ``train_ds``'s validation, ``test_ds`` and ``video_retrieval``'s
  extraction as two ranks over sets whose batches do not split evenly
  (batches of 5 videos, a ragged last batch; 5 videos per retrieval split):
  the one-process logits, scores and features, the padding rows dropped,
  and every file written once, by rank 0.
* The ``train_ds`` CLI as two ranks under torchrun's environment: only rank 0
  prints and writes, and its checkpoint equals the one-process CLI's to
  1e-5.  ``test_ds`` runs as two ranks through ``--world_size 2 --rank R
  --dist-url``, ``video_retrieval`` under torchrun's environment.
* The pieces: the ``train`` augmentation's row window, the train loader's
  ``batch_slice``.

The ranks of the first four points share one spawn (a module fixture).
"""

import glob
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_util as du
from _torch_port_util import np_tree, rel_l2
from video_graph_ssl_tpu.engine import create_downstream_state as jax_state
from video_graph_ssl_tpu.engine.downstream import make_downstream_train_step as jax_step
from video_graph_ssl_tpu.models import create_video_model as jax_create
from video_graph_ssl_tpu_torch import test_ds, video_retrieval
from video_graph_ssl_tpu_torch.data import transforms_device as ttd
from video_graph_ssl_tpu_torch.data.build import make_data_loader
from video_graph_ssl_tpu_torch.engine.build import (create_downstream_state,
                                                    create_pretrain_state)
from video_graph_ssl_tpu_torch.models.build import create_video_model, create_visual_model
from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config
from video_graph_ssl_tpu_torch.utils.checkpoint import save_checkpoint_state
from video_graph_ssl_tpu_torch.utils.jax_weights import (downstream_state_dict,
                                                         load_downstream_weights)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
B, T, H, W = 4, 4, 16, 16
LRS = (0.1, 0.05, 0.1)
TOL_JAX = 1e-4
TOL_PORT = 1e-5
# (MODEL.LINEAR_PROBE, MODEL.PROBE_BN) of the lockstep with JAX
JAX_CASES = {"finetune_graph": (False, "eval"), "probe_eval": (True, "eval"),
             "probe_reference": (True, "reference")}
FUSED_CASES = {"finetune": ["MODEL.DROPOUT", 0.5],
               "probe_reference": ["MODEL.LINEAR_PROBE", True, "MODEL.PROBE_BN", "reference"]}
# 8 classes: 32 validation videos in batches of 5, the last of 2
VAL_OPTS = ["TEST.BATCH_SIZE", 5, "MODEL.DROPOUT", 0.5]


def _batch():
    g = np.random.default_rng(0)
    return (g.standard_normal((B, T, H, W, 3)).astype(np.float32),
            g.integers(0, 8, B).astype(np.int32))


def _raw():
    g = np.random.default_rng(1)
    return (g.integers(0, 256, (B, T, 20, 20, 3), np.uint8),
            g.integers(0, 8, B).astype(np.int64))


def _jax_opts(case):
    probe, probe_bn = JAX_CASES[case]
    return ["GRAPH.SAMPLER", "none", "MODEL.LINEAR_PROBE", probe, "MODEL.PROBE_BN", probe_bn]


def _assert_ranks_equal(ranks):
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


@pytest.fixture(scope="module")
def two_ranks(tiny_cfg, tmp_path_factory):
    """One spawn of two ranks: the JAX cases' steps from JAX's initial
    state, the fused cases' steps from ``MODEL.SEED``, and ``train_ds``'s
    validation; plus JAX's model, state and optimizer of each case."""
    clips, labels = _batch()
    raw, raw_labels = _raw()
    jax_runs, calls = {}, []
    for case in sorted(JAX_CASES):
        probe, probe_bn = JAX_CASES[case]
        c = tiny_cfg.clone()
        c.MODEL.LINEAR_PROBE, c.MODEL.PROBE_BN, c.GRAPH.SAMPLER = probe, probe_bn, "none"
        jmodel, _ = jax_create(c)
        state, tx = jax_state(c, jmodel, jnp.asarray(clips[:2]))
        model, _ = create_video_model(du.port_cfg(_jax_opts(case)))
        load_downstream_weights(model, np_tree(state.params), np_tree(state.batch_stats))
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        jax_runs[case] = (jmodel, state, tx, sd)
        calls.append((du.ds_step_worker, (_jax_opts(case), sd, clips, labels, LRS, False)))
    for case in sorted(FUSED_CASES):
        calls.append((du.ds_step_worker, (FUSED_CASES[case], None, raw, raw_labels, LRS, True)))
    directory = tmp_path_factory.mktemp("ddp_downstream")
    calls.append((du.ds_validation_worker, (VAL_OPTS, str(directory / "ranks"))))
    per_rank = du.run_ranks(du.several_worker, 2, directory, calls)
    runs = [list(r) for r in zip(*per_rank)]
    names = [*sorted(JAX_CASES), *(f"fused {c}" for c in sorted(FUSED_CASES)), "validation"]
    return {"jax": jax_runs, "ranks": dict(zip(names, runs)), "dir": directory,
            "batch": (clips, labels), "raw": (raw, raw_labels)}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_two_ranks_match_jax_single_device_step(two_ranks, case):
    probe, probe_bn = JAX_CASES[case]
    jmodel, state, tx, sd = two_ranks["jax"][case]
    ranks = two_ranks["ranks"][case]
    clips, labels = two_ranks["batch"]
    jstep = jax.jit(jax_step(jmodel, tx, not probe or probe_bn == "reference"))
    batch = {"clips": jnp.asarray(clips), "label": jnp.asarray(labels)}
    jm = []
    for lr in LRS:
        state, m = jstep(state, batch, lr)
        jm.append({k: float(v) for k, v in m.items()})
    _assert_ranks_equal(ranks)
    got = ranks[0]
    assert got["ddp"]
    for ours, ref in zip(got["metrics"], jm):
        assert sorted(ours) == sorted(ref) == ["loss", "top1", "top5"]
        assert abs(ours["loss"] - ref["loss"]) <= TOL_JAX * abs(ref["loss"])
        for k in ("top1", "top5"):
            assert ours[k] == pytest.approx(ref[k])
    st = got["state"]
    assert int(st["step"]) == int(state.step) == 3
    ref = downstream_state_dict(np_tree(state.params), np_tree(state.batch_stats), "tiny3d")
    assert sorted(k for k in st if k.startswith("model.")) == sorted(f"model.{k}" for k in ref)
    for k, v in ref.items():
        assert rel_l2(st[f"model.{k}"], v) < TOL_JAX, k
    if probe:   # the encoder's parameters bit for bit; new_fc moved
        held = [k for k in sd if not k.startswith("new_fc") and "running" not in k]
        for k in held:
            np.testing.assert_array_equal(st[f"model.{k}"], sd[k], err_msg=k)
        assert not np.array_equal(st["model.new_fc.weight"], sd["new_fc.weight"])


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_two_ranks_match_the_one_process_fused_step(two_ranks, case):
    raw, raw_labels = two_ranks["raw"]
    ranks = two_ranks["ranks"][f"fused {case}"]
    one = du.ds_step_worker(0, 1, FUSED_CASES[case], None, raw, raw_labels, LRS, True)
    _assert_ranks_equal(ranks)
    assert ranks[0]["ddp"] and not one["ddp"]
    for ours, ref in zip(ranks[0]["metrics"], one["metrics"]):
        assert abs(ours["loss"] - ref["loss"]) <= TOL_PORT * abs(ref["loss"])
    assert sorted(ranks[0]["state"]) == sorted(one["state"])
    for k, v in one["state"].items():
        assert rel_l2(ranks[0]["state"][k], v) < TOL_PORT, k
    # each rank's augmented clips: its rows of the one-process augmentation
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["augmented"], one["augmented"][du.rows(r, 2, B)])


def test_one_rank_in_a_group_is_the_no_group_step_bit_for_bit(tmp_path):
    raw, raw_labels = _raw()
    opts = FUSED_CASES["finetune"]
    (rank,) = du.run_ranks(du.ds_step_worker, 1, tmp_path, opts, None, raw, raw_labels, LRS,
                           True)
    one = du.ds_step_worker(0, 1, opts, None, raw, raw_labels, LRS, True)
    assert rank["ddp"] and rank["metrics"] == one["metrics"]
    for k, v in one["state"].items():
        np.testing.assert_array_equal(rank["state"][k], v, err_msg=k)


def test_validation_on_two_ranks_is_one_process(two_ranks):
    ranks = two_ranks["ranks"]["validation"]
    one_dir = str(two_ranks["dir"] / "one")
    one = du.ds_validation_worker(0, 1, VAL_OPTS, one_dir)
    assert one["logits"].shape == (32, 8)
    for res in ranks:
        # every rank holds the whole set's logits, in order, padding dropped
        np.testing.assert_array_equal(res["labels"], one["labels"])
        assert rel_l2(res["logits"], one["logits"]) < TOL_PORT
        np.testing.assert_array_equal(res["logits"], ranks[0]["logits"])
        assert res["top1"] == one["top1"]
    # rank 0 alone owns the experiment and wrote model_best_state once
    assert ranks[1]["experiment_dir"] is None
    rel = [os.path.relpath(p, str(two_ranks["dir"] / "ranks")) for p in ranks[1]["written"]]
    assert rel == [os.path.relpath(p, one_dir) for p in one["written"]] == [
        "kinetics/video_model/experiment_00/model_best_state.pth.tar",
        "kinetics/video_model/model_best.pth.tar"]


def test_train_augment_rows_are_the_global_draws_rows():
    c = du.port_cfg()
    raw = torch.from_numpy(_raw()[0].repeat(2, axis=0))
    fn = ttd.make_batch_augment_fn(c, "train")
    whole = fn(torch.Generator().manual_seed(3), raw)
    for lo, hi in ((0, 4), (2, 6), (4, 8)):
        part = fn(torch.Generator().manual_seed(3), raw[lo:hi], (lo, 8))
        assert torch.equal(part, whole[lo:hi])
    p = ttd.draw_train_params(8, torch.Generator().manual_seed(3), "cpu", 5)
    assert torch.equal(p.rows(2, 6).pair, p.pair[2:6])
    with pytest.raises(ValueError, match="outside"):
        p.rows(6, 9)


def test_train_loader_batch_slice():
    c = du.port_cfg(["DATALOADER.BATCH_SIZE", 8])
    whole = list(make_data_loader(c, True).epoch(1))
    part = list(make_data_loader(c, True, batch_slice=(4, 8)).epoch(1))
    assert len(part) == len(whole) == 4
    for a, b in zip(part, whole):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k][4:8])
    with pytest.raises(ValueError, match="drop_last"):
        make_data_loader(c, False, batch_slice=(0, 4))


# --------------------------------------------------------------------------- #
# the CLIs as two rank processes
TINY = ["MODEL.BACKBONE", "tiny3d", "MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "synthetic",
        "DATASET.NUM_CLASS", "4", "DATALOADER.BATCH_SIZE", "4", "DATALOADER.NUM_WORKERS", "2",
        "TEST.BATCH_SIZE", "5", "INPUT.VIDEO_LENGTH", "4", "INPUT.SCALE_SIZE", "[20, 20]",
        "INPUT.BASE_SIZE", "[16, 16]", "INPUT.CROP_SIZE", "[16, 16]",
        "TPU.COMPUTE_DTYPE", "float32", "CHECKPOINT.PRINT_FREQ", "1"]
DS = ["--config_file", os.path.join(CONFIGS, "smoke_ds.yaml"), *TINY]
PRETRAIN = ["--config_file", os.path.join(CONFIGS, "visual_moco.yaml"), *TINY,
            "CONTRAST.NCE_K", "16", "CROSS.FEAT_DIM", "32"]


def _free_port() -> str:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return str(sock.getsockname()[1])


def _tool(module, cwd, args, **env_vars):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **env_vars)
    return subprocess.Popen([sys.executable, "-m", f"video_graph_ssl_tpu_torch.{module}",
                             "--device", "cpu", "--dist-backend", "gloo", *args],
                            cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _torchrun_env(rank, port):
    return dict(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                MASTER_ADDR="localhost", MASTER_PORT=port)


def _finish(procs):
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * len(procs), "\n".join(o[-3000:] for o in outs)
    return outs


def _written(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "**", "*.pth.tar"), recursive=True))


def test_train_ds_cli_on_two_ranks(tmp_path):
    ranks_dir, one_dir = tmp_path / "ranks", tmp_path / "one"
    ranks_dir.mkdir()
    one_dir.mkdir()
    port = _free_port()
    args = [*DS, "--max_steps", "2"]
    procs = [_tool("train_ds", ranks_dir, args, **_torchrun_env(r, port)) for r in range(2)]
    procs.append(_tool("train_ds", one_dir, args))
    outs = _finish(procs)
    # rank 0 logs the steps and the validation, rank 1 is silent
    assert outs[0].count("Epoch: [0]") == 2 and "Validation:" in outs[0]
    assert "Epoch:" not in outs[1] and "Validation:" not in outs[1]
    assert _written(ranks_dir) == _written(one_dir) == [
        "run/synthetic/smoke_ds/experiment_00/checkpoint_1.pth.tar",
        "run/synthetic/smoke_ds/experiment_00/model_best_state.pth.tar",
        "run/synthetic/smoke_ds/model_best.pth.tar"]
    name = "run/synthetic/smoke_ds/experiment_00/checkpoint_1.pth.tar"
    a = torch.load(ranks_dir / name, weights_only=True)
    b = torch.load(one_dir / name, weights_only=True)
    assert a["step"] == b["step"] == 2 and a["meta"] == b["meta"]
    assert sorted(a["state_dict"]) == sorted(b["state_dict"])
    for k, v in b["state_dict"].items():
        assert rel_l2(a["state_dict"][k].numpy(), v.numpy()) < TOL_PORT, k


def _test_ds_run(tmp_path):
    """test_ds as two ranks through --dist-url and as one process, on a
    fresh downstream checkpoint over the 8 test videos (batches of 5 and 3);
    (rank outputs, rank files, one-process files)."""
    config = load_config(DS[1], TINY)
    ckpt = str(tmp_path / "ds.pth.tar")
    save_checkpoint_state(ckpt, create_downstream_state(config, create_video_model(config)[0],
                                                        "cpu"), epoch=1)
    args = [*DS, "--checkpoint", ckpt, "--test_crops", "3", "--test_clips", "2"]
    url = "file://" + str(tmp_path / "rendezvous")
    files = [str(tmp_path / f"scores_rank{r}.npz") for r in range(2)]
    procs = [_tool("test_ds", tmp_path, [*args, "--world_size", "2", "--rank", str(r),
                                         "--dist-url", url, "--save_scores", files[r]])
             for r in range(2)]
    one = str(tmp_path / "scores_one.npz")
    rep = test_ds.main([*args, "--device", "cpu", "--save_scores", one])
    assert rep["confusion"].sum() == 8
    return _finish(procs), files, [one]


def _retrieval_run(tmp_path):
    """video_retrieval as two ranks under torchrun's environment and as one
    process, on a fresh pretrain checkpoint, 5 videos per split (one batch
    of 5)."""
    config = load_config(PRETRAIN[1], PRETRAIN[2:])
    ckpt = str(tmp_path / "pretrain.pth.tar")
    save_checkpoint_state(ckpt, create_pretrain_state(config, create_visual_model(config)[0],
                                                      "cpu"), epoch=1)
    args = [*PRETRAIN, "--checkpoint", ckpt, "--extract_feature", "--test_clips", "2",
            "--max_videos", "5"]
    port = _free_port()
    dirs = [str(tmp_path / f"feats_rank{r}") for r in range(2)]
    procs = [_tool("video_retrieval", tmp_path, [*args, "--feature_dir", dirs[r]],
                   **_torchrun_env(r, port)) for r in range(2)]
    one = str(tmp_path / "feats_one")
    recalls = video_retrieval.main([*args, "--device", "cpu", "--feature_dir", one])
    assert set(recalls) == {1, 5}
    return _finish(procs), dirs, [one]


@pytest.mark.parametrize("tool", ["test_ds", "video_retrieval"])
def test_eval_tool_on_two_ranks(tmp_path, tool):
    outs, rank_files, (one,) = (_test_ds_run if tool == "test_ds" else _retrieval_run)(tmp_path)
    report = "Accuracy Prec@1" if tool == "test_ds" else "R@1:"
    assert outs[0].count(report) == 1 and report not in outs[1]
    # rank 0 alone writes
    assert os.path.exists(rank_files[0]) and not os.path.exists(rank_files[1])
    if tool == "test_ds":
        got, ref = np.load(rank_files[0]), np.load(one)
        np.testing.assert_array_equal(got["labels"], ref["labels"])
        assert got["scores"].shape == (8, 4)
        assert rel_l2(got["scores"], ref["scores"]) < TOL_PORT
        return
    assert sorted(os.listdir(rank_files[0])) == sorted(os.listdir(one)) == [
        "topk_correct.json", "train_features.pkl", "val_features.pkl"]
    for split in ("train", "val"):
        with open(os.path.join(rank_files[0], f"{split}_features.pkl"), "rb") as f:
            got = pickle.load(f)
        with open(os.path.join(one, f"{split}_features.pkl"), "rb") as f:
            ref = pickle.load(f)
        np.testing.assert_array_equal(got["classes"], ref["classes"])
        assert got["features"].shape == (5, 64)
        assert rel_l2(got["features"], ref["features"]) < TOL_PORT
