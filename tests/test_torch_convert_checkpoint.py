"""The port's reference-checkpoint converter (``utils/ckpt_convert.py``,
``convert_checkpoint.py``) against JAX's on the CPU.

* The state dicts ``tests/test_ckpt_convert.py`` builds (a reference
  ``GraphWrapper`` MoCo state dict: the backbone's shape manifest with
  seeded values and the MLP head; its CMC two-stack and downstream forms),
  for S3D, S3DG, I3D, R3D-10, ResNet-50 2D and BN-Inception, and S3D with
  graph blocks at 5, 9, 14: the port's converted names and values equal
  JAX's converted tree carried across by ``utils/jax_weights.py``, value
  for value; the port's model of that config loads them strictly; the
  export back to the reference's names and in again is bit-exact (and,
  but for BN-Inception's folded conv biases, equals the reference's
  state dict itself).
* Backbones JAX's converter does not cover are refused with JAX's message,
  ``i3d_res50_nonlocal`` with JAX's reason as well; so is a graph-wrapped
  S3DG or I3D, whose layout no converter defines.
* The CLI on ``torch.save``'d payloads, ``--device cpu``: a reference R3D-10
  MoCo checkpoint (EMA encoder, memory, epoch 3) becomes a port checkpoint
  that the trainer's resume, ``train_ds --ssl_checkpoint`` and
  ``video_retrieval --checkpoint`` take; a downstream one that ``test_ds``
  takes; a CMC one; each exported back to the reference's names and
  converted again, bit for bit; a bank's row count comes from the payload.
"""

import functools
import os

import numpy as np
import pytest
import torch

from test_ckpt_convert import _head_manifest, _rand_sd
from video_graph_ssl_tpu.utils import ckpt_convert as jax_cc
from video_graph_ssl_tpu.utils import torch_interop as ti
from video_graph_ssl_tpu_torch import convert_checkpoint as cc
from video_graph_ssl_tpu_torch import test_ds, train_ds, video_retrieval
from video_graph_ssl_tpu_torch import train_video_contrast_dis as pretrain
from video_graph_ssl_tpu_torch.models import build
from video_graph_ssl_tpu_torch.utils import jax_weights
from video_graph_ssl_tpu_torch.utils.checkpoint import mismatches
from video_graph_ssl_tpu_torch.utils.ckpt_convert import (layout, port_state_dict,
                                                          reference_state_dict)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
# registry name -> (reference manifest, feature dim, backbone type)
BACKBONES = {
    "S3D": (ti.reference_s3d_shape_manifest, 1024, "3D"),
    "S3DG": (ti.reference_s3dg_shape_manifest, 1024, "3D"),
    "I3D": (ti.reference_i3d_shape_manifest, 1024, "3D"),
    "resnet3d_10": (functools.partial(ti.reference_resnet_shape_manifest, 10, 3), 512, "3D"),
    "resnet50": (functools.partial(ti.reference_resnet_shape_manifest, 50, 2), 2048, "2D"),
    "bninception": (ti.reference_bninception_shape_manifest, 1024, "2D"),
}
FEAT_DIM = 8


def reference_sd(name, kind="pretrain", seed=0):
    """A reference state dict of ``kind``, as tests/test_ckpt_convert.py
    builds one (classifier included where the manifest has one)."""
    manifest, dim, _ = BACKBONES[name]
    enc = _rand_sd(manifest(num_classes=10), seed)
    if kind == "downstream":
        return {**{f"base_model.{k}": v for k, v in enc.items()},
                "new_fc.weight": _rand_sd({"w": (4, dim)}, seed + 1)["w"],
                "new_fc.bias": _rand_sd({"b": (4,)}, seed + 2)["b"]}
    sd = {f"model.encoder.base_model.{k}": v for k, v in enc.items()}
    sd.update({f"model.proj_head.{k}": v
               for k, v in _rand_sd(_head_manifest(in_dim=dim, feat_dim=FEAT_DIM),
                                    seed + 1).items()})
    return sd


def port_cfg(name, kind="pretrain", aug=False):
    c = pretrain.load_config("", [
        "MODEL.BACKBONE", name, "MODEL.BACKBONE_TYPE", BACKBONES[name][2],
        "MODEL.AUG_FLAG", str(aug), "CROSS.FEAT_DIM", str(FEAT_DIM),
        "CROSS.MODALITY", "cross" if kind == "cmc_pretrain" else "visual",
        "DATASET.NUM_CLASS", "4"])
    return c


def port_model(c, kind, monkeypatch):
    monkeypatch.setattr(build, "init_params_", lambda *a, **k: None)
    return (build.create_video_model(c) if kind == "downstream"
            else build.create_visual_model(c))[0]


def assert_same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]), err_msg=k)


def assert_round_trip(port, name, kind):
    tensors = {k: torch.from_numpy(v) for k, v in port.items()}
    back = port_state_dict(reference_state_dict(tensors, name, kind), name, kind)
    assert_same({k: v.numpy() for k, v in back.items()}, port)


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_pretrain_equals_jax_converter(name, monkeypatch):
    sd = reference_sd(name)
    port = port_state_dict(sd, name, "pretrain")
    p, s = jax_cc.convert_pretrain_sd(sd, name, "moco", "mlp")
    assert_same(port, jax_weights.pretrain_state_dict(p, s, name))
    port_model(port_cfg(name), "pretrain", monkeypatch).load_state_dict(
        {k: torch.from_numpy(v) for k, v in port.items()}, strict=True)
    assert_round_trip(port, name, "pretrain")
    if name != "bninception":
        # the classifier is dropped, as the reference's encoder wrapper drops it
        ref = {k: v for k, v in sd.items()
               if not k.startswith(("model.encoder.base_model.fc.",
                                    "model.encoder.base_model.features.18.",
                                    "model.encoder.base_model.conv3d_0c_1x1."))}
        assert_same(reference_state_dict(port, name, "pretrain"), ref)
    else:
        # its conv biases are folded into the BN means, and come back zero
        back = reference_state_dict({k: torch.from_numpy(v) for k, v in port.items()},
                                    name, "pretrain")
        biases = [k for k in back if k.endswith(".conv.bias")]
        assert biases and all(float(back[k].abs().max()) == 0.0 for k in biases)


@pytest.mark.parametrize("kind", ["downstream", "cmc_pretrain"])
def test_downstream_and_cmc_equal_jax_converter(kind, monkeypatch):
    if kind == "downstream":
        sd = reference_sd("S3D", "downstream")
        p, s = jax_cc.convert_downstream_sd(sd, "S3D")
        theirs = jax_weights.downstream_state_dict(p, s, "S3D")
    else:
        sd = {f"{st}.{k}": v for i, st in enumerate(("model_1", "model_2"))
              for k, v in reference_sd("S3D", seed=30 + i).items()}
        p, s = jax_cc.convert_cmc_pretrain_sd(sd, "s3d")
        theirs = jax_weights.pretrain_state_dict(p, s, "S3D")
    port = port_state_dict({f"module.{k}": v for k, v in sd.items()}, "S3D", kind)
    assert_same(port, theirs)
    port_model(port_cfg("S3D", kind), kind, monkeypatch).load_state_dict(
        {k: torch.from_numpy(v) for k, v in port.items()}, strict=True)
    assert_round_trip(port, "S3D", kind)


def test_graph_blocks_equal_jax_converter(monkeypatch):
    """S3D with graph blocks at 5, 9, 14 (the reference's ``base.N.0``
    wraps): the port's and JAX's converted names and values agree."""
    model = port_model(port_cfg("S3D", aug=True), "pretrain", monkeypatch)
    g = np.random.default_rng(3)
    sd = {k: (g.uniform(0.5, 1.5, v.shape) if k.endswith("running_var")
              else g.normal(0, 0.1, v.shape)).astype(np.float32)
          for k, v in model.state_dict().items()}
    assert any(".5.0.g_q." in k for k in sd)
    p, s = jax_cc.convert_pretrain_sd(sd, "S3D", "moco", "mlp")
    assert sorted(k for k in p["model"]["encoder"]["base_model"] if "graph" in k) == [
        "graph_aug_14", "graph_aug_5", "graph_aug_9"]
    port = port_state_dict(sd, "S3D", "pretrain")
    assert_same(port, jax_weights.pretrain_state_dict(p, s, "S3D"))
    assert_same(port, sd)
    assert_round_trip(port, "S3D", "pretrain")


@pytest.mark.parametrize("name,stage", [("S3DG", "features.5"), ("I3D", "mixed_3b")])
def test_refuses_graph_wrapped_non_s3d(name, stage, monkeypatch):
    """Graph blocks convert on S3D only: JAX splits ``base.N.0`` wraps alone,
    so a reference S3DG or I3D payload whose stage is wrapped fails there,
    and the port refuses it in both directions."""
    enc = "model.encoder.base_model."
    sd = {(k.replace(f"{enc}{stage}.", f"{enc}{stage}.1.", 1)): v
          for k, v in reference_sd(name).items()}
    sd[f"{enc}{stage}.0.g_q.0.weight"] = np.zeros((4, 4, 1, 1, 1), np.float32)
    with pytest.raises(Exception):
        jax_cc.convert_pretrain_sd(sd, name, "moco", "mlp")
    with pytest.raises(NotImplementedError, match="graph blocks"):
        port_state_dict(sd, name, "pretrain")
    model = port_model(port_cfg(name, aug=True), "pretrain", monkeypatch)
    with pytest.raises(NotImplementedError, match="graph blocks"):
        reference_state_dict(model.state_dict(), name, "pretrain")


@pytest.mark.parametrize("name", ["i3d_res50_nonlocal", "tiny3d"])
def test_refuses_what_jax_refuses(name):
    sd = {"model.encoder.base_model.conv1.weight": np.zeros((1,))}
    with pytest.raises(NotImplementedError) as jax_err:
        jax_cc.convert_pretrain_sd(sd, name, "moco")
    with pytest.raises(NotImplementedError) as port_err:
        port_state_dict(sd, name, "pretrain")
    want = f"no torch converter for backbone '{name}'"
    assert str(jax_err.value).startswith(want) and str(port_err.value).startswith(want)
    if name == "i3d_res50_nonlocal":
        assert "non-local weights" in str(port_err.value)
        assert "layer3's 6 blocks" in str(port_err.value)
    with pytest.raises(NotImplementedError):
        layout(name)


# the tools at a tiny size on the CPU: R3D-10 (graph off), 8x32x32
TINY = ["MODEL.BACKBONE", "resnet3d_10", "MODEL.AUG_FLAG", "False", "DATASET.SOURCE",
        "synthetic", "DATASET.NUM_CLASS", "4", "DATALOADER.BATCH_SIZE", "2",
        "DATALOADER.NUM_WORKERS", "1", "TEST.BATCH_SIZE", "2", "INPUT.VIDEO_LENGTH", "8",
        "INPUT.SCALE_SIZE", "[36, 36]", "INPUT.BASE_SIZE", "[32, 32]", "INPUT.CROP_SIZE",
        "[32, 32]", "TPU.COMPUTE_DTYPE", "float32", "CHECKPOINT.PRINT_FREQ", "1"]
PRETRAIN = ["--config_file", os.path.join(CONFIGS, "visual_moco.yaml"), *TINY,
            "CONTRAST.NCE_K", "16", "CROSS.FEAT_DIM", str(FEAT_DIM)]
DS = ["--config_file", os.path.join(CONFIGS, "smoke_ds.yaml"), *TINY]


def _save(path, payload):
    torch.save({k: ({n: torch.from_numpy(v) for n, v in val.items()}
                    if isinstance(val, dict) else val) for k, val in payload.items()}, path)
    return str(path)


def _memory(rows, seed):
    m = np.random.default_rng(seed).normal(size=(rows, FEAT_DIM)).astype(np.float32)
    return m / np.linalg.norm(m, axis=-1, keepdims=True)


def test_cli_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    sd = reference_sd("resnet3d_10", seed=21)
    ema = reference_sd("resnet3d_10", seed=23)
    src = _save(tmp_path / "ref.pth.tar", {
        "epoch": 3, "state_dict": sd, "model_ema": ema,
        "contrast": {"memory": _memory(16, 22)}, "optimizer": {}})
    out = cc.main([*PRETRAIN, "--device", "cpu", "--torch_ckpt", src,
                   "--output", str(tmp_path / "port.pth.tar")])
    payload = torch.load(out, weights_only=True)
    meta = payload["meta"]
    assert meta["epoch"] == 3 and meta["optimizer"] == "reinitialized"
    assert meta["model_ema"] == "converted" and meta["contrast"].startswith("converted")
    np.testing.assert_array_equal(payload["contrast"]["queue"].numpy(), _memory(16, 22))
    assert_same({k: v.numpy() for k, v in payload["state_dict"].items()},
                port_state_dict(sd, "resnet3d_10", "pretrain"))
    assert_same({k: v.numpy() for k, v in payload["model_ema"].items()},
                port_state_dict(ema, "resnet3d_10", "pretrain"))

    # the trainer's resume, train_ds's surgery, retrieval
    trainer = pretrain.Trainer(pretrain.load_config(PRETRAIN[1], PRETRAIN[2:] + [
        "CHECKPOINT.RESUME", out]), max_steps=1, device="cpu", run_dir=str(tmp_path / "run"))
    assert trainer.start_epoch == 3
    assert not mismatches(trainer.state.model.state_dict(), payload["state_dict"])
    del trainer
    capsys.readouterr()
    train_ds.main([*DS, "--device", "cpu", "--max_steps", "1", "--ssl_checkpoint", out])
    assert f"initialized encoder from '{out}'" in capsys.readouterr().out
    recalls = video_retrieval.main([*PRETRAIN, "--device", "cpu", "--checkpoint", out,
                                    "--extract_feature", "--feature_dir",
                                    str(tmp_path / "feats"), "--test_clips", "1",
                                    "--max_videos", "4"])
    assert sorted(recalls) == [1]

    # back to the reference's names, and in again: bit for bit
    back = cc.main([*PRETRAIN, "--checkpoint", out, "--to_torch", str(tmp_path / "back.pth")])
    ref = torch.load(back, weights_only=True)
    assert ref["epoch"] == 3 and sorted(ref) == ["contrast", "epoch", "model_ema",
                                                   "state_dict"]
    drop = "model.encoder.base_model.fc."
    assert_same({k: v.numpy() for k, v in ref["state_dict"].items()},
                {k: v for k, v in sd.items() if not k.startswith(drop)})
    again = torch.load(cc.main([*PRETRAIN, "--device", "cpu", "--torch_ckpt", back,
                                "--output", str(tmp_path / "again.pth.tar")]),
                       weights_only=True)
    for part in ("state_dict", "model_ema", "contrast"):
        assert not mismatches(again[part], payload[part]), part

    # a downstream checkpoint, evaluated by test_ds
    ds_src = _save(tmp_path / "ds.pth.tar", {"epoch": 5, "state_dict": reference_sd(
        "resnet3d_10", "downstream", seed=25)})
    ds_out = cc.main([*DS, "--device", "cpu", "--torch_ckpt", ds_src])
    assert ds_out == str(tmp_path / "ds_port.pth.tar")
    rep = test_ds.main([*DS, "--device", "cpu", "--checkpoint", ds_out, "--test_crops", "1",
                        "--test_clips", "1", "--max_videos", "4"])
    assert rep["confusion"].sum() == 4
    ds_back = torch.load(cc.main([*DS, "--checkpoint", ds_out, "--to_torch",
                                  str(tmp_path / "ds_back.pth")]), weights_only=True)
    assert sorted(ds_back) == ["epoch", "state_dict"] and ds_back["epoch"] == 5
    assert not mismatches(
        ds_back["state_dict"],
        {k: torch.from_numpy(v) for k, v in reference_sd("resnet3d_10", "downstream",
                                                          seed=25).items()
         if not k.startswith("base_model.fc.")})


@pytest.mark.parametrize("mem_type", ["moco", "bank"])
def test_cli_cmc_and_bank_round_trip(tmp_path, mem_type):
    """A CMC payload (two stacks, memory_1 and memory_2) of each memory: the
    bank's 40 rows come from the payload; exported and converted again,
    bit for bit."""
    rows = 16 if mem_type == "moco" else 40
    sd = {f"{st}.{k}": v for i, st in enumerate(("model_1", "model_2"))
          for k, v in reference_sd("resnet3d_10", seed=40 + i).items()}
    src = _save(tmp_path / "cmc.pth.tar", {
        "epoch": 2, "state_dict": sd,
        "contrast": {"memory_1": _memory(rows, 50), "memory_2": _memory(rows, 51)}})
    opts = [*PRETRAIN, "CROSS.MODALITY", "cross", "CONTRAST.MEM_TYPE", mem_type,
            "--device", "cpu"]
    out = cc.main([*opts, "--torch_ckpt", src])
    payload = torch.load(out, weights_only=True)
    field = "queue" if mem_type == "moco" else "memory"
    for i in (1, 2):
        np.testing.assert_array_equal(payload["contrast"][f"{field}_{i}"].numpy(),
                                      _memory(rows, 49 + i))
    assert payload["meta"]["contrast"] == (f"converted ('memory_1' -> {field}_1, "
                                           f"'memory_2' -> {field}_2)")
    back = cc.main([*opts, "--checkpoint", out, "--to_torch", str(tmp_path / "back.pth")])
    again = torch.load(cc.main([*opts, "--torch_ckpt", back, "--output",
                                str(tmp_path / "again.pth.tar")]), weights_only=True)
    for part in ("state_dict", "contrast") + (("model_ema",) if mem_type == "moco" else ()):
        assert not mismatches(again[part], payload[part]), part
