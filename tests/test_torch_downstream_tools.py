"""The port's downstream tools on the CPU (``--device cpu``), tiny3d.

* ``test_ds.build_eval_fn`` and ``video_retrieval.build_feature_fn``
  against the JAX tools' own functions (``tools/test_ds.py`` and
  ``tools/video_retrieval.py``, imported from their files) on the same
  weights and uint8 clips: 1e-5 (rel-L2).
* ``topk_retrieval`` gives JAX's R@k and ``topk_correct.json`` on given
  features, for cosine and euclidean distances.
* End to end: a pretrain checkpoint of the port's trainer, ``train_ds`` for
  2 steps from it (surgery, validation, ``model_best_state`` and
  ``checkpoint_1``), ``test_ds`` on the best checkpoint (scores, the
  confusion matrix, ``--save_scores``), then ``video_retrieval`` on the
  pretrain checkpoint; the surgery copies the encoder and keeps ``new_fc``.
* SIGTERM during ``train_ds`` writes ``checkpoint_preempt``.
* A bad ``MODEL.PROBE_BN`` and a non-pretrain checkpoint raise; a CMC
  checkpoint gives ``model_1``'s encoder; ``TPU.SEPCONV_FUSED`` with ``MODEL.NO_PARTIALBN`` (S3D) trains one
  step through torchrun's launcher and builds at a world size above 1.
"""

import glob
import importlib.util
import json
import os
import pickle
import signal
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import np_tree, rel_l2
from video_graph_ssl_tpu.engine import create_downstream_state as jax_ds_state
from video_graph_ssl_tpu.engine import create_pretrain_state as jax_pt_state
from video_graph_ssl_tpu.models import create_video_model as jax_video_model
from video_graph_ssl_tpu.models import create_visual_model as jax_visual_model
from video_graph_ssl_tpu_torch import test_ds, train_ds, video_retrieval
from video_graph_ssl_tpu_torch import train_video_contrast_dis as pretrain
from video_graph_ssl_tpu_torch.engine.build import create_downstream_state
from video_graph_ssl_tpu_torch.engine.downstream import make_fused_downstream_step
from video_graph_ssl_tpu_torch.models.build import create_video_model, create_visual_model
from video_graph_ssl_tpu_torch.utils.checkpoint import load_params_only, transfer_encoder_params
from video_graph_ssl_tpu_torch.utils.jax_weights import (load_downstream_weights,
                                                         load_pretrain_weights)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
TINY = ["MODEL.BACKBONE", "tiny3d", "MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "synthetic",
        "DATASET.NUM_CLASS", "4", "DATALOADER.BATCH_SIZE", "4", "DATALOADER.NUM_WORKERS", "2",
        "TEST.BATCH_SIZE", "4", "INPUT.VIDEO_LENGTH", "4", "INPUT.SCALE_SIZE", "[20, 20]",
        "INPUT.BASE_SIZE", "[16, 16]", "INPUT.CROP_SIZE", "[16, 16]",
        "TPU.COMPUTE_DTYPE", "float32", "CHECKPOINT.PRINT_FREQ", "1"]
PRETRAIN = ["--config_file", os.path.join(CONFIGS, "visual_moco.yaml"), *TINY,
            "CONTRAST.NCE_K", "16", "CROSS.FEAT_DIM", "32", "SOLVER.MAX_EPOCHS", "1"]
DS = ["--config_file", os.path.join(CONFIGS, "smoke_ds.yaml"), *TINY]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _raw(seed=0, b=2, clips=3):
    return np.random.default_rng(seed).integers(0, 256, (b, clips, 4, 20, 20, 3), np.uint8)


@pytest.mark.parametrize("n_crops", [3, 10])
def test_build_eval_fn_matches_jax(tiny_cfg, n_crops):
    c = tiny_cfg.clone()
    c.GRAPH.SAMPLER = "none"
    raw = _raw()
    jmodel, _ = jax_video_model(c)
    state, _ = jax_ds_state(c, jmodel, jnp.zeros((2, 4, 16, 16, 3)))
    ref = _jax_tool("test_ds").build_eval_fn(c, jmodel, n_crops)(state, jnp.asarray(raw))
    model, _ = create_video_model(c)
    load_downstream_weights(model, np_tree(state.params), np_tree(state.batch_stats))
    ours = test_ds.build_eval_fn(c, n_crops)(model, torch.from_numpy(raw))
    assert ours.shape == (2, 8)
    assert rel_l2(ours.numpy(), ref) < 1e-5


@pytest.mark.parametrize("n_crops", [1, 5])
def test_build_feature_fn_matches_jax(tiny_cfg, n_crops):
    c = tiny_cfg.clone()
    c.CONTRAST.MEM_TYPE = "moco"
    raw = _raw(1)
    jmodel, _ = jax_visual_model(c)
    state, _ = jax_pt_state(c, jmodel, jnp.zeros((2, 4, 16, 16, 3)), n_data=1)
    ref = _jax_tool("video_retrieval").build_feature_fn(c, jmodel, n_crops)(
        state, jnp.asarray(raw))
    model, _ = create_visual_model(c)
    load_pretrain_weights(model, np_tree(state.params), np_tree(state.batch_stats), "tiny3d")
    ours = video_retrieval.build_feature_fn(c, n_crops)(model, torch.from_numpy(raw))
    assert ours.shape == (2, 64)
    assert rel_l2(ours.numpy(), ref) < 1e-5


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_topk_retrieval_matches_jax(tmp_path, metric):
    g = np.random.default_rng(5)
    feats = {"train": g.standard_normal((60, 16)).astype(np.float32),
             "val": g.standard_normal((20, 16)).astype(np.float32)}
    feats["train"][3] = 0.0      # a zero row: the 1e-12 clamp
    classes = {"train": g.integers(0, 6, 60), "val": g.integers(0, 6, 20)}
    results = {}
    for who, fn in (("jax", _jax_tool("video_retrieval").topk_retrieval),
                    ("port", video_retrieval.topk_retrieval)):
        d = tmp_path / who
        d.mkdir()
        for split in ("train", "val"):
            with open(d / f"{split}_features.pkl", "wb") as f:
                pickle.dump({"features": feats[split], "classes": classes[split]}, f)
        args = SimpleNamespace(feature_dir=str(d), l2_norm=True, dist_metric=metric,
                               save_vis=0)
        results[who] = (fn(args), json.load(open(d / "topk_correct.json")))
    assert results["port"] == results["jax"]
    assert sorted(results["port"][0]) == [1, 5, 10, 20, 50]   # k <= 60 train videos
    assert results["port"][1]["50"] >= results["port"][1]["1"]


def test_tools_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    pretrain.main([*PRETRAIN, "--device", "cpu", "--max_steps", "2"])
    ssl = str(tmp_path / "run" / "kinetics-400" / "visual_model_s3d" / "experiment_00"
              / "checkpoint_1.pth.tar")
    capsys.readouterr()
    train_ds.main([*DS, "--device", "cpu", "--max_steps", "2", "--ssl_checkpoint", ssl])
    out = capsys.readouterr().out
    assert f"initialized encoder from '{ssl}'" in out
    assert len([l for l in out.splitlines() if l.startswith("Epoch: [0][")]) == 2
    assert "Validation: [Epoch: 0] Prec@1" in out
    exp = tmp_path / "run" / "synthetic" / "smoke_ds" / "experiment_00"
    best = exp / "model_best_state.pth.tar"
    assert (exp / "checkpoint_1.pth.tar").exists()
    payload = torch.load(best, weights_only=True)
    assert {k.split(".")[0] for k in payload["state_dict"]} == {"base_model", "new_fc"}
    assert "contrast" not in payload and "model_ema" not in payload and payload["step"] == 2
    scores = str(tmp_path / "scores.npz")
    rep = test_ds.main([*DS, "--device", "cpu", "--checkpoint", str(best), "--test_crops", "3",
                        "--test_clips", "2", "--max_videos", "8", "--save_scores", scores])
    saved = np.load(scores)
    assert saved["scores"].shape == (8, 4) and np.isfinite(saved["scores"]).all()
    assert rep["confusion"].sum() == 8 and 0.0 <= rep["mean_class_acc"] <= 100.0
    assert "Accuracy Prec@1" in capsys.readouterr().out
    feats = str(tmp_path / "feats")
    recalls = video_retrieval.main([*PRETRAIN, "--device", "cpu", "--checkpoint", ssl,
                                    "--extract_feature", "--feature_dir", feats,
                                    "--test_clips", "2", "--max_videos", "8"])
    train = pickle.load(open(os.path.join(feats, "train_features.pkl"), "rb"))
    assert train["features"].shape == (8, 64) and np.isfinite(train["features"]).all()
    assert sorted(recalls) == [1, 5] and os.path.exists(os.path.join(feats,
                                                                     "topk_correct.json"))


def test_surgery_copies_the_encoder_and_keeps_new_fc(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pretrain.main([*PRETRAIN, "--device", "cpu", "--max_steps", "1",
                   "CONTRAST.MEM_TYPE", "simsiam"])
    ssl = str(tmp_path / "run" / "kinetics-400" / "visual_model_s3d" / "experiment_00"
              / "checkpoint_1.pth.tar")
    config = pretrain.load_config(DS[1], TINY[:-2])
    trainer = train_ds.Trainer(config, ssl_checkpoint=ssl, device="cpu",
                               run_dir=str(tmp_path / "ds"))
    sd, _ = load_params_only(ssl)
    for k, v in trainer.state.model.base_model.state_dict().items():
        assert torch.equal(v, sd[f"model.encoder.base_model.{k}"]), k
    fresh, _ = create_video_model(config)
    assert torch.equal(trainer.state.model.new_fc.weight, fresh.new_fc.weight)
    # PRETRAIN_PATH '/' or 'none': the random encoder
    for none in ("/", "none"):
        t = train_ds.Trainer(pretrain.load_config(DS[1], TINY + ["MODEL.PRETRAIN_PATH", none]),
                             device="cpu", run_dir=str(tmp_path / "ds"))
        for k, v in t.state.model.state_dict().items():
            assert torch.equal(v, fresh.state_dict()[k]), k
    # a CMC checkpoint: model_1's encoder (tests/test_torch_cmc_tools.py)
    enc = {k: v for k, v in sd.items() if k.startswith("model.encoder.base_model.")}
    transfer_encoder_params({f"model_{i}.{k}": v + i for i in (1, 2) for k, v in enc.items()},
                            fresh)
    for k, v in fresh.base_model.state_dict().items():
        assert torch.equal(v, enc[f"model.encoder.base_model.{k}"] + 1), k
    with pytest.raises(KeyError, match="not a pretrain checkpoint"):
        transfer_encoder_params({"model_1.encoder.base_model.stage0.conv.weight":
                                 torch.zeros(1)}, fresh)
    with pytest.raises(KeyError, match="not a pretrain checkpoint"):
        transfer_encoder_params(fresh.state_dict(), fresh)
    with pytest.raises(RuntimeError, match="no SSL checkpoint"):
        train_ds.Trainer(config, ssl_checkpoint=str(tmp_path / "missing.pth.tar"),
                         device="cpu", run_dir=str(tmp_path / "ds"))


def test_sigterm_writes_checkpoint_preempt(tmp_path):
    config = pretrain.load_config(DS[1], TINY + ["SOLVER.MAX_EPOCHS", "1000",
                                                 "CHECKPOINT.CHECKNAME", "preempt_ds"])
    trainer = train_ds.Trainer(config, device="cpu", run_dir=str(tmp_path / "run"))
    step, calls = trainer.train_step, []

    def step_then_sigterm(*a):
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*a)

    trainer.train_step = step_then_sigterm
    trainer.run()
    ckpt = os.path.join(trainer.saver.experiment_dir, "checkpoint_preempt.pth.tar")
    payload = torch.load(ckpt, weights_only=True)
    assert len(calls) == 2 and payload["epoch"] == 0 and payload["step"] == 2
    assert json.load(open(ckpt + ".meta.json"))["step"] == 2
    assert signal.getsignal(signal.SIGTERM) is not trainer._on_sigterm


def test_refusals(tmp_path, monkeypatch):
    from video_graph_ssl_tpu_torch.parallel import dist

    bad = pretrain.load_config(DS[1], TINY + ["MODEL.PROBE_BN", "train"])
    with pytest.raises(ValueError, match="PROBE_BN"):
        train_ds.Trainer(bad, device="cpu", run_dir=str(tmp_path))
    config = pretrain.load_config(DS[1], TINY)
    # K5 across ranks (TPU.SEPCONV_FUSED with MODEL.NO_PARTIALBN) builds and
    # trains: under the torchrun environment, through the launcher, which
    # joins the group (one gloo rank here), takes a step and leaves it; and
    # at world size 2 the model and the step build (two ranks train in
    # tests/test_torch_fused_ranks.py)
    fused = ["TPU.SEPCONV_FUSED", "True", "MODEL.NO_PARTIALBN", "True", "MODEL.BACKBONE",
             "S3D", "MODEL.AUG_FLAG", "False", "INPUT.VIDEO_LENGTH", "8",
             "INPUT.SCALE_SIZE", "[36, 36]", "INPUT.BASE_SIZE", "[32, 32]",
             "INPUT.CROP_SIZE", "[32, 32]", "SOLVER.MAX_EPOCHS", "1"]
    calls = []
    init, destroy = dist.init_distributed, torch.distributed.destroy_process_group
    with monkeypatch.context() as m:
        for var, value in zip(dist.TORCHRUN_VARS,
                              ("0", "1", "localhost", str(pretrain._free_port()))):
            m.setenv(var, value)
        m.setattr(dist, "init_distributed",
                  lambda backend, *a: (calls.append(backend), init(backend, *a)))
        m.setattr(torch.distributed, "destroy_process_group",
                  lambda: (calls.append("left"), destroy()))
        m.chdir(tmp_path)
        train_ds.main([*DS, "--device", "cpu", "--dist-backend", "gloo", "--max_steps", "1",
                       *fused])
    assert calls == ["gloo", "left"]
    assert glob.glob(str(tmp_path / "run" / "**" / "metrics.jsonl"), recursive=True)
    with monkeypatch.context() as m:
        m.setattr(dist, "world_size", lambda: 2)
        fused_cfg = pretrain.load_config(DS[1], TINY + fused)
        assert callable(make_fused_downstream_step(fused_cfg))
        model, _ = create_video_model(fused_cfg)
        assert sum(getattr(s, "fused", False) for s in model.modules()) == 18
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ds.Trainer(pretrain.load_config(DS[1], TINY), device="cuda",
                         run_dir=str(tmp_path))
    state = create_downstream_state(config, create_video_model(config)[0], "cpu")
    assert state.ema_model is None and state.contrast is None
    assert state.seed == int(config.MODEL.SEED) + 2


@pytest.mark.parametrize("probe", [False, True])
def test_downstream_checkpoint_round_trip(tmp_path, probe):
    """A downstream checkpoint (one torch.save file in the reference's
    VideoModelWrapper layout plus its .meta.json) loads strictly into a
    fresh state and gives the saved state bit for bit, the SGD momentum of
    the parameters the optimizer holds included."""
    from video_graph_ssl_tpu_torch.engine.downstream import make_fused_downstream_step
    from video_graph_ssl_tpu_torch.utils.checkpoint import (checkpoint_payload,
                                                            load_checkpoint_state, mismatches,
                                                            save_checkpoint_state)

    config = pretrain.load_config(DS[1], TINY + ["MODEL.LINEAR_PROBE", str(probe)])
    state = create_downstream_state(config, create_video_model(config)[0], "cpu")
    raw = torch.from_numpy(_raw(2, b=4, clips=1)[:, 0])
    step = make_fused_downstream_step(config, train_ds.bn_train_of(config))
    for lr in (0.1, 0.05):
        step(state, raw, torch.arange(4) % 4, lr)
    path = str(tmp_path / "ds.pth.tar")
    save_checkpoint_state(path, state, epoch=3, best_pred=12.5)
    fresh = create_downstream_state(config, create_video_model(config, seed=7)[0], "cpu")
    meta = load_checkpoint_state(path, fresh)
    assert meta == {"epoch": 3, "best_pred": 12.5, "step": 2}
    assert json.load(open(path + ".meta.json")) == meta
    assert mismatches(checkpoint_payload(state, 3), checkpoint_payload(fresh, 3)) == []
    n_momentum = len(fresh.optimizer.state_dict()["state"])
    assert n_momentum == (2 if probe else len(list(fresh.model.parameters())))
