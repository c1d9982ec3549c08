"""CMC (``CROSS.MODALITY cross``) through the port's checkpoints and tools on
the CPU, tiny3d.

* Checkpoint round trip: the fused CMC step (augmentation, both stacks'
  graph draws, the bank's negatives) 4 steps straight equals 2 steps, a
  checkpoint, a restore into a fresh state (other weights, other memory)
  and 2 steps, bit for bit; the checkpoint holds JAX's names
  (``queue_1``, ``queue_2``, ``ptr``; ``memory_1``, ``memory_2``) and the
  EMA stacks for MoCo; a visual checkpoint does not load into a CMC state.
* The trainer's entry point trains CMC MoCo and bank for 2 steps; then
  ``train_ds`` fine-tunes from that checkpoint (the surgery takes
  ``model_1``'s encoder), ``video_retrieval`` loads it strictly and
  retrieves, and ``MODEL.PRETRAIN_PATH`` warm-starts every stack's backbone
  from it (its RGB stack's).
* ``video_retrieval.build_feature_fn`` on a CMC model equals the JAX
  tool's (the RGB stack's encoder) within 1e-5; the surgery and the layout
  detection (``torch_names.detect_kind``) against JAX's.
"""

import glob
import importlib.util
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import np_tree, rel_l2
from test_torch_cmc import cmc_cfg
from video_graph_ssl_tpu.engine import create_pretrain_state as jax_pt_state
from video_graph_ssl_tpu.models import create_visual_model as jax_visual_model
from video_graph_ssl_tpu.utils.ckpt_convert import detect_kind as jax_detect_kind
from video_graph_ssl_tpu_torch import train_ds, video_retrieval
from video_graph_ssl_tpu_torch import train_video_contrast_dis as pretrain
from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
from video_graph_ssl_tpu_torch.engine.pretrain import make_fused_pretrain_step
from video_graph_ssl_tpu_torch.models.build import create_video_model, create_visual_model
from video_graph_ssl_tpu_torch.utils.checkpoint import (checkpoint_payload,
                                                        load_checkpoint_state, mismatches,
                                                        save_checkpoint_state,
                                                        transfer_encoder_params)
from video_graph_ssl_tpu_torch.utils.jax_weights import load_pretrain_weights
from video_graph_ssl_tpu_torch.utils.torch_names import detect_kind

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
B, T = 4, 4
N_DATA = 16
TINY = ["MODEL.BACKBONE", "tiny3d", "MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "synthetic",
        "DATASET.NUM_CLASS", "4", "DATALOADER.BATCH_SIZE", "4", "DATALOADER.NUM_WORKERS", "2",
        "TEST.BATCH_SIZE", "4", "INPUT.VIDEO_LENGTH", "4", "INPUT.SCALE_SIZE", "[20, 20]",
        "INPUT.BASE_SIZE", "[16, 16]", "INPUT.CROP_SIZE", "[16, 16]",
        "TPU.COMPUTE_DTYPE", "float32", "CHECKPOINT.PRINT_FREQ", "1"]
CMC = ["CROSS.MODALITY", "cross", "CONTRAST.NCE_K", "16", "CROSS.FEAT_DIM", "32",
       "SOLVER.MAX_EPOCHS", "1"]
PRETRAIN = ["--config_file", os.path.join(CONFIGS, "visual_moco.yaml"), *TINY, *CMC]
DS = ["--config_file", os.path.join(CONFIGS, "smoke_ds.yaml"), *TINY]


def _raw(n, seed=0):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.integers(0, 256, (B, 2, T, 20, 20, 3), dtype=np.uint8))
            for _ in range(n)]


def _fresh(c, seed=None):
    model, _ = create_visual_model(c, seed=seed)
    return create_pretrain_state(c, model, "cpu", n_data=N_DATA)


@pytest.mark.parametrize("mem_type", ["moco", "bank"])
def test_cmc_checkpoint_round_trip_and_resume_bit_for_bit(tmp_path, mem_type):
    c = cmc_cfg(mem_type=mem_type, sampler="relaxed_bernoulli")
    batches = _raw(4, seed=1)
    index = [torch.arange(B) + B * (i % 2) for i in range(4)]
    lrs = (0.1, 0.1, 0.05, 0.05)
    step = make_fused_pretrain_step(c)
    straight = _fresh(c)
    for clips, idx, lr in zip(batches, index, lrs):
        last = step(straight, clips, lr, idx)

    first = _fresh(c)
    for clips, idx, lr in zip(batches[:2], index[:2], lrs[:2]):
        step(first, clips, lr, idx)
    path = str(tmp_path / "mid.pth.tar")
    save_checkpoint_state(path, first, epoch=1)
    payload = torch.load(path, weights_only=True)
    if mem_type == "moco":
        assert set(payload["contrast"]) == {"queue_1", "queue_2", "ptr"}
        assert payload["contrast"]["ptr"] == 2 * B
        assert {k.split(".")[0] for k in payload["model_ema"]} == {"model_1", "model_2"}
    else:
        assert set(payload["contrast"]) == {"memory_1", "memory_2"}
        assert payload["contrast"]["memory_1"].shape == (N_DATA, 32)
        assert "model_ema" not in payload
    resumed = _fresh(c, seed=7)
    assert mismatches(checkpoint_payload(first, 1), checkpoint_payload(resumed, 1))
    load_checkpoint_state(path, resumed)
    assert mismatches(checkpoint_payload(first, 1), checkpoint_payload(resumed, 1)) == []
    for clips, idx, lr in zip(batches[2:], index[2:], lrs[2:]):
        again = step(resumed, clips, lr, idx)
    assert torch.equal(last["loss"], again["loss"])
    assert mismatches(checkpoint_payload(straight, 2), checkpoint_payload(resumed, 2)) == []
    # the visual regime's checkpoint does not fit the CMC memory
    visual = c.clone()
    visual.CROSS.MODALITY = "visual"
    vpath = str(tmp_path / "visual.pth.tar")
    save_checkpoint_state(vpath, _fresh(visual), epoch=1)
    with pytest.raises((KeyError, RuntimeError)):
        load_checkpoint_state(vpath, _fresh(c))


@pytest.mark.parametrize("mem_type", ["moco", "bank"])
def test_trainer_cli_trains_cmc_and_the_tools_load_it(tmp_path, monkeypatch, capsys,
                                                      mem_type):
    monkeypatch.chdir(tmp_path)
    opts = PRETRAIN + ["CONTRAST.MEM_TYPE", mem_type]
    pretrain.main([*opts, "--device", "cpu", "--max_steps", "2"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("Epoch: [0]")]
    assert len(lines) == 2 and "Loss" in lines[0] and "Prec@1" in lines[0]
    (ssl,) = glob.glob(str(tmp_path / "run" / "**" / "checkpoint_1.pth.tar"), recursive=True)
    payload = torch.load(ssl, weights_only=True)
    sd = payload["state_dict"]
    assert payload["step"] == 2 and {k.split(".")[0] for k in sd} == {"model_1", "model_2"}
    if mem_type == "moco":
        assert set(payload["contrast"]) == {"queue_1", "queue_2", "ptr"}
    else:   # a bank of NUM_CLASS x 4 rows per modality
        assert payload["contrast"]["memory_2"].shape == (16, 32)

    # MODEL.PRETRAIN_PATH: every stack's backbone (and the EMA stacks') from
    # the checkpoint's RGB stack
    c = pretrain.load_config(opts[1], opts[2:] + ["MODEL.PRETRAINED", "True",
                                                  "MODEL.PRETRAIN_PATH", ssl])
    trainer = pretrain.Trainer(c, device="cpu", run_dir=str(tmp_path / "warm"))
    rgb = "model_1.model.encoder.base_model."
    for model in (trainer.state.model, trainer.state.ema_model):
        if model is None:
            continue
        for stack in ("model_1", "model_2"):
            got = getattr(model, stack).model.encoder.base_model.state_dict()
            for k, v in got.items():
                assert torch.equal(v, sd[rgb + k]), (stack, k)

    # train_ds: the surgery takes model_1's encoder
    capsys.readouterr()
    train_ds.main([*DS, "--device", "cpu", "--max_steps", "2", "--ssl_checkpoint", ssl])
    out = capsys.readouterr().out
    assert f"initialized encoder from '{ssl}'" in out and "Validation: [Epoch: 0]" in out
    (best,) = glob.glob(str(tmp_path / "run" / "synthetic" / "**" / "model_best_state.pth.tar"),
                        recursive=True)
    assert {k.split(".")[0] for k in torch.load(best, weights_only=True)["state_dict"]} == {
        "base_model", "new_fc"}
    ds = train_ds.Trainer(pretrain.load_config(DS[1], DS[2:]), ssl_checkpoint=ssl,
                          device="cpu", run_dir=str(tmp_path / "ds2"))
    for k, v in ds.state.model.base_model.state_dict().items():
        assert torch.equal(v, sd[rgb + k]), k

    # video_retrieval: the CMC model loads strictly, features from model_1
    feats = str(tmp_path / "feats")
    recalls = video_retrieval.main([*opts, "--device", "cpu", "--checkpoint", ssl,
                                    "--extract_feature", "--feature_dir", feats,
                                    "--test_clips", "2", "--max_videos", "8"])
    train = pickle.load(open(os.path.join(feats, "train_features.pkl"), "rb"))
    assert train["features"].shape == (8, 64) and np.isfinite(train["features"]).all()
    assert sorted(recalls) == [1, 5]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_retrieval_features_of_a_cmc_model_match_jax():
    c = cmc_cfg()
    raw = np.random.default_rng(1).integers(0, 256, (2, 3, 4, 20, 20, 3), np.uint8)
    jmodel, _ = jax_visual_model(c)
    state, _ = jax_pt_state(c, jmodel, jnp.zeros((2, 4, 16, 16, 3)), n_data=1)
    ref = _jax_tool("video_retrieval").build_feature_fn(c, jmodel, 3)(state, jnp.asarray(raw))
    model, _ = create_visual_model(c)
    load_pretrain_weights(model, np_tree(state.params), np_tree(state.batch_stats), "tiny3d")
    ours = video_retrieval.build_feature_fn(c, 3)(model, torch.from_numpy(raw))
    assert ours.shape == (2, 64)
    assert rel_l2(ours.numpy(), ref) < 1e-5


def test_surgery_and_layout_detection_match_jax():
    c = cmc_cfg()
    cmc, _ = create_visual_model(c)
    sd = cmc.state_dict()
    visual = c.clone()
    visual.CROSS.MODALITY = "visual"
    video, _ = create_video_model(visual)
    fresh_fc = video.new_fc.weight.clone()
    transfer_encoder_params(sd, video)
    for k, v in video.base_model.state_dict().items():
        assert torch.equal(v, sd[f"model_1.model.encoder.base_model.{k}"]), k
    assert torch.equal(video.new_fc.weight, fresh_fc)
    layouts = {"cmc": sd, "ddp cmc": {f"module.{k}": v for k, v in sd.items()},
               "pretrain": create_visual_model(visual)[0].state_dict(),
               "downstream": video.state_dict()}
    for name, layout in layouts.items():
        assert detect_kind(layout) == jax_detect_kind(layout), name
    assert detect_kind(sd) == "cmc_pretrain"
    for bad in ({"base.0.conv.weight": 0}, {"model_1.x": 0}):
        with pytest.raises(ValueError, match="unrecognized"):
            jax_detect_kind(bad)
        with pytest.raises(ValueError, match="unrecognized"):
            detect_kind(bad)
