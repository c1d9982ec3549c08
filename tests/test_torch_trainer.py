"""The port's pretrain trainer on the CPU (``--device cpu``, tiny3d): its
host side against the JAX tool's behaviour.

* The CLI trains 2 epochs from a shard store the test writes, saves at
  ``CHECKPOINT.CHECKPOINT_INTERVAL``, and a second run with
  ``CHECKPOINT.RESUME`` starts at the saved epoch with the same losses.
* SIGTERM finishes the step, writes ``checkpoint_preempt.pth.tar`` carrying
  the current epoch and exits 0 (as ``tests/test_preemption.py`` holds the
  JAX tool).
* ``--max_steps`` counts across epochs; ``--profile_dir`` writes a trace;
  ``MODEL.PRETRAIN_PATH`` warm-starts both encoders' backbones strictly,
  from a bare backbone or a whole checkpoint the port's ``Saver`` wrote,
  taking from the latter what JAX's ``load_backbone_init`` takes.
* The saver (experiment directories, best-pred promotion across sibling
  experiments, ``parameters.txt``), the summary writer and the shard
  builder CLI against the JAX package's; the saver's sharded backend
  (``TPU.CKPT_BACKEND orbax``) writes a directory that reads back.
"""

import glob
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from video_graph_ssl_tpu_torch import build_shards
from video_graph_ssl_tpu_torch import train_video_contrast_dis as train
from video_graph_ssl_tpu_torch.data.shards import write_shard_store
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.utils import saver as psaver
from video_graph_ssl_tpu_torch.utils import summary as psummary

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "visual_moco.yaml")
TINY = ["MODEL.BACKBONE", "tiny3d", "MODEL.AUG_FLAG", "True", "DATASET.NUM_CLASS", "4",
        "DATALOADER.BATCH_SIZE", "4", "DATALOADER.NUM_WORKERS", "2",
        "INPUT.VIDEO_LENGTH", "4", "INPUT.SCALE_SIZE", "[20, 20]",
        "INPUT.BASE_SIZE", "[16, 16]", "CONTRAST.NCE_K", "16", "CROSS.FEAT_DIM", "32",
        "CHECKPOINT.PRINT_FREQ", "1"]
SYNTHETIC = TINY + ["DATASET.SOURCE", "synthetic"]


def _store(root):
    """8 videos of 12 frames at the 20x20 canvas, written by the port."""
    split = os.path.join(root, "split.txt")
    with open(split, "w") as f:
        for v in range(8):
            f.write(f"video_{v} 12 {v % 4}\n")

    def frame_source(directory, idx):
        v = int(os.path.basename(directory).split("_")[1])
        return np.random.default_rng((v, idx)).integers(0, 256, (20, 20, 3), np.uint8)

    store = os.path.join(root, "store")
    write_shard_store(os.path.join(root, "frames"), [split], store, (20, 20),
                      frame_source=frame_source)
    return store, split


def _epoch_lines(out):
    return [l for l in out.splitlines() if l.startswith("Epoch: [")]


def _experiment(root, n):
    return os.path.join(root, "run", "kinetics-400", "visual_model_s3d",
                        f"experiment_{n:02d}")


def test_cli_trains_from_a_store_saves_and_resumes(tmp_path, monkeypatch, capsys):
    store, split = _store(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    opts = TINY + ["DATASET.SOURCE", "frames", "INPUT.PRE_LOAD", "shard",
                   "DATASET.VISUAL_ROOT_DIR", store, "DATASET.TRAIN_SPLIT", split,
                   "SOLVER.MAX_EPOCHS", "2", "CHECKPOINT.CHECKPOINT_INTERVAL", "1"]
    train.main(["--config_file", CONFIG, "--device", "cpu", *opts])
    first = _epoch_lines(capsys.readouterr().out)
    assert [l.split("]")[0] for l in first] == ["Epoch: [0"] * 2 + ["Epoch: [1"] * 2
    exp = _experiment(str(tmp_path), 0)
    for n in (1, 2):
        meta = json.load(open(os.path.join(exp, f"checkpoint_{n}.pth.tar.meta.json")))
        assert meta == {"epoch": n, "best_pred": 0.0, "step": 2 * n}
    tags = [json.loads(l)["tag"] for l in open(os.path.join(exp, "metrics.jsonl"))]
    assert tags.count("train/total_loss_iter") == 4
    for tag in ("train/loss", "train/top1_acc", "train/top5_acc", "lr"):
        assert tags.count(tag) == 2, tag
    assert "INPUT:\n" in open(os.path.join(exp, "parameters.txt")).read()

    ckpt = os.path.join(exp, "checkpoint_1.pth.tar")
    train.main(["--config_file", CONFIG, "--device", "cpu", *opts,
                "CHECKPOINT.RESUME", ckpt])
    out = capsys.readouterr().out
    assert f"=> loaded checkpoint '{ckpt}' (epoch 1)" in out
    resumed = _epoch_lines(out)
    # the same epoch-1 steps, down to the printed loss and accuracy
    strip = [l.split("\tTime")[0] + l.split("\tLoss")[1] for l in first[2:]]
    assert [l.split("\tTime")[0] + l.split("\tLoss")[1] for l in resumed] == strip
    assert os.path.exists(os.path.join(_experiment(str(tmp_path), 1), "checkpoint_2.pth.tar"))


def test_max_steps_counts_across_epochs_and_profile_dir(tmp_path, capsys):
    c = train.load_config(CONFIG, SYNTHETIC + ["SOLVER.MAX_EPOCHS", "5"])
    trainer = train.Trainer(c, max_steps=6, device="cpu", run_dir=str(tmp_path / "run"),
                            profile_dir=str(tmp_path / "trace"))
    assert len(trainer.train_loader) == 4
    trainer.run()
    out = capsys.readouterr().out
    assert [l.split("/")[0] for l in _epoch_lines(out)] == \
        [f"Epoch: [0][{i}" for i in range(4)] + [f"Epoch: [1][{i}" for i in range(2)]
    assert trainer.state.step == 6
    # the trace starts at step 5 of the first epoch, which has 4: none taken
    assert not os.path.exists(tmp_path / "trace")

    c = train.load_config(CONFIG, SYNTHETIC + ["DATASET.NUM_CLASS", "12"])
    trainer = train.Trainer(c, max_steps=11, device="cpu", run_dir=str(tmp_path / "run"),
                            profile_dir=str(tmp_path / "trace"))
    trainer.run()
    assert "profiler trace written" in capsys.readouterr().out
    events = json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "query_pass" for e in events)


def test_sigterm_writes_a_preemption_checkpoint_and_exits_0(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "video_graph_ssl_tpu_torch.train_video_contrast_dis",
         "--config_file", CONFIG, "--device", "cpu", *SYNTHETIC,
         "SOLVER.MAX_EPOCHS", "100000", "CHECKPOINT.CHECKNAME", "preempt_test"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines, deadline = [], time.time() + 240
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("Epoch: [0]["):
                proc.send_signal(signal.SIGTERM)
                break
            assert time.time() < deadline, "".join(lines[-20:])
        else:
            pytest.fail("the trainer exited before its first step:\n" + "".join(lines[-20:]))
        rest, _ = proc.communicate(timeout=120)
        lines.append(rest)
    finally:
        if proc.poll() is None:
            proc.kill()
    out = "".join(lines)
    assert proc.returncode == 0, out[-2000:]
    assert "Preemption Checkpoint" in out, out[-2000:]
    exp = glob.glob(str(tmp_path / "run" / "*" / "preempt_test" / "experiment_*"))
    ckpt = os.path.join(exp[0], "checkpoint_preempt.pth.tar")
    assert os.path.exists(ckpt)
    assert torch.load(ckpt, weights_only=True)["epoch"] == 0
    assert json.load(open(ckpt + ".meta.json"))["epoch"] == 0


def test_pretrain_path_warm_starts_both_backbones(tmp_path):
    c = train.load_config(CONFIG, SYNTHETIC)
    donor, _ = create_visual_model(c, seed=123)
    backbone = donor.model.encoder.base_model.state_dict()
    path = str(tmp_path / "backbone.pth.tar")
    torch.save({"state_dict": {f"module.encoder.base_model.{k}": v
                               for k, v in backbone.items()}}, path)
    c = train.load_config(CONFIG, SYNTHETIC + ["MODEL.PRETRAINED", "True",
                                               "MODEL.PRETRAIN_PATH", path])
    trainer = train.Trainer(c, device="cpu", run_dir=str(tmp_path / "run"))
    for model in (trainer.state.model, trainer.state.ema_model):
        got = model.model.encoder.base_model.state_dict()
        assert sorted(got) == sorted(backbone)
        for k, v in backbone.items():
            assert torch.equal(got[k], v), k
    head = trainer.state.model.model.proj_head.state_dict()
    assert not all(torch.equal(v, donor.model.proj_head.state_dict()[k])
                   for k, v in head.items())

    # a whole pretrain checkpoint (heads, EMA, optimizer) as the Saver writes it
    donor_c = train.load_config(CONFIG, SYNTHETIC + ["MODEL.SEED", "123"])
    donor_t = train.Trainer(donor_c, device="cpu", run_dir=str(tmp_path / "donor"))
    path = donor_t.saver.save_checkpoint(donor_t.state, 1)
    c = train.load_config(CONFIG, SYNTHETIC + ["MODEL.PRETRAINED", "True",
                                               "MODEL.PRETRAIN_PATH", path])
    trainer = train.Trainer(c, device="cpu", run_dir=str(tmp_path / "run"))
    for model in (trainer.state.model, trainer.state.ema_model):
        got = model.model.encoder.base_model.state_dict()
        for k, v in donor_t.state.model.model.encoder.base_model.state_dict().items():
            assert torch.equal(got[k], v), k

    path = str(tmp_path / "backbone.pth.tar")
    torch.save({k: v for k, v in list(backbone.items())[1:]}, path)
    c = train.load_config(CONFIG, SYNTHETIC + ["MODEL.PRETRAINED", "True",
                                               "MODEL.PRETRAIN_PATH", path])
    with pytest.raises(RuntimeError, match="Missing key"):
        train.Trainer(c, device="cpu", run_dir=str(tmp_path / "run"))
    os.remove(path)
    with pytest.raises(RuntimeError, match="no pretrain backbone"):
        train.Trainer(c, device="cpu", run_dir=str(tmp_path / "run"))


def test_pretrain_path_from_a_saver_checkpoint_matches_jax(tmp_path):
    """An S3D pretrain checkpoint written by the port's Saver (heads, EMA and
    optimizer included) warm-starts the backbone with the weights JAX's
    ``load_backbone_init`` takes from the same file."""
    from video_graph_ssl_tpu.utils.ckpt_convert import load_backbone_init
    from video_graph_ssl_tpu_torch.utils.jax_weights import s3d_state_dict

    s3d = SYNTHETIC + ["MODEL.BACKBONE", "S3D", "MODEL.AUG_FLAG", "False"]
    donor = train.Trainer(train.load_config(CONFIG, s3d + ["MODEL.SEED", "123"]),
                          device="cpu", run_dir=str(tmp_path / "donor"))
    path = donor.saver.save_checkpoint(donor.state, 1)
    c = train.load_config(CONFIG, s3d + ["MODEL.PRETRAINED", "True",
                                         "MODEL.PRETRAIN_PATH", path])
    trainer = train.Trainer(c, device="cpu", run_dir=str(tmp_path / "run"))
    ref = s3d_state_dict(*load_backbone_init(path, "S3D"))
    want = donor.state.model.model.encoder.base_model.state_dict()
    assert sorted(ref) == sorted(want)
    for model in (trainer.state.model, trainer.state.ema_model):
        got = model.model.encoder.base_model.state_dict()
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
            assert torch.equal(got[k], want[k]), k
    assert not torch.equal(trainer.state.model.model.proj_head.head[0].weight,
                           donor.state.model.model.proj_head.head[0].weight)


# --------------------------------------------------------------------------- #
def _jax_cfg(opts):
    from video_graph_ssl_tpu.config import cfg

    c = cfg.clone()
    c.merge_from_file(CONFIG)
    c.merge_from_list(opts)
    return c


def test_saver_matches_jax(tmp_path, monkeypatch):
    """The same sequence of saves through both savers: experiment numbering,
    best_pred.txt and the promotion of model_best across sibling
    experiments, and parameters.txt."""
    from video_graph_ssl_tpu.utils import checkpoint as jckpt
    from video_graph_ssl_tpu.utils.saver import Saver as JaxSaver

    monkeypatch.setattr(jckpt, "save_checkpoint_state",
                        lambda path, state, *a, **k: open(path, "w").write(state))
    monkeypatch.setattr(psaver, "save_checkpoint_state",
                        lambda path, state, *a, **k: open(path, "w").write(state))
    pc = train.load_config(CONFIG, SYNTHETIC)
    jc = _jax_cfg(SYNTHETIC)
    listing = {}
    for name, saver_cls, c, ext in (("port", psaver.Saver, pc, ".pth.tar"),
                                    ("jax", JaxSaver, jc, ".msgpack")):
        base = str(tmp_path / name)
        for run, preds in enumerate(([3.0, 5.0], [4.0], [6.0, 2.0])):
            s = saver_cls(c, base_dir=base)
            s.save_experiment_config()
            for k, p in enumerate(preds):
                s.save_checkpoint(f"{run}:{k}", epoch=k, best_pred=p, is_best=True,
                                  filename=f"checkpoint{ext}")
        files = {}
        for path in sorted(glob.glob(os.path.join(base, "**", "*"), recursive=True)):
            if os.path.isfile(path):
                rel = os.path.relpath(path, base).replace(ext, ".ckpt")
                files[rel] = open(path).read()
        listing[name] = files
    assert listing["port"] == listing["jax"]
    best = [k for k in listing["port"] if "model_best" in k]
    assert len(best) == 1 and listing["port"][best[0]] == "2:0"


def test_orbax_backend_is_not_ported(tmp_path):
    """Formerly the saver refused ``TPU.CKPT_BACKEND orbax``; now it writes
    the sharded backend's directory (``checkpoint_1.dcp`` and its meta
    file, promoted to ``model_best.dcp``) and the state reads back from it
    bit for bit."""
    from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
    from video_graph_ssl_tpu_torch.utils.checkpoint import (checkpoint_payload,
                                                            load_checkpoint_state, mismatches)

    c = train.load_config(CONFIG, SYNTHETIC + ["TPU.CKPT_BACKEND", "orbax"])
    state = create_pretrain_state(c, create_visual_model(c)[0], "cpu")
    s = psaver.Saver(c, base_dir=str(tmp_path))
    path = s.save_checkpoint(state, epoch=1, best_pred=2.0, is_best=True,
                             filename="checkpoint_1.pth.tar")
    assert path.endswith("checkpoint_1.dcp") and os.path.isdir(path)
    assert os.path.isfile(path + ".meta.json")
    best = os.path.join(s.directory, "model_best.dcp")
    assert os.path.isdir(best) and os.path.isfile(best + ".meta.json")
    for src in (path, best):
        fresh = create_pretrain_state(c, create_visual_model(c, seed=9)[0], "cpu")
        assert load_checkpoint_state(src, fresh)["epoch"] == 1
        assert mismatches(checkpoint_payload(state, 1), checkpoint_payload(fresh, 1)) == []


@pytest.mark.parametrize("tensorboard", [True, False])
def test_summary_matches_jax(tmp_path, monkeypatch, tensorboard):
    from video_graph_ssl_tpu.utils import summary as jsummary

    if not tensorboard:
        monkeypatch.setattr(psummary, "_summary_writer", lambda: None)
        monkeypatch.setattr(jsummary, "_HAS_TB", False)
    records = {}
    for name, mod in (("port", psummary), ("jax", jsummary)):
        w = mod.TensorboardSummary(str(tmp_path / name))
        assert (w.writer is not None) == (tensorboard and psummary._summary_writer()
                                          is not None)
        for step, v in enumerate((1.5, np.float32(2.25), 3)):
            w.add_scalar("train/loss", v, step)
        w.close()
        records[name] = [{k: v for k, v in json.loads(l).items() if k != "t"}
                         for l in open(tmp_path / name / "metrics.jsonl")]
    assert records["port"] == records["jax"] and len(records["port"]) == 3


def test_build_shards_cli_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    frames = tmp_path / "frames"
    split = tmp_path / "split.txt"
    with open(split, "w") as f:
        for v, n in enumerate((5, 7)):
            d = frames / f"v{v}"
            os.makedirs(d)
            g = np.random.default_rng(v)
            for i in range(1, n + 1):
                cv2.imwrite(str(d / f"img_{i:05d}.jpg"),
                            g.integers(0, 256, (30, 40, 3), np.uint8))
            f.write(f"v{v} {n} {v}\n")
    opts = ["DATASET.VISUAL_ROOT_DIR", str(frames), "DATASET.TRAIN_SPLIT", str(split),
            "DATASET.VALIDATION_SPLIT", str(split), "INPUT.IMG_TMP", "img_{:05d}.jpg",
            "INPUT.SCALE_SIZE", "[24, 32]"]
    spec = importlib.util.spec_from_file_location(
        "jax_build_shards", os.path.join(REPO, "tools", "build_shards.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    jax_tool.main(["--cfg", CONFIG, "--out", str(tmp_path / "jax"), *opts])
    assert build_shards.main(["--cfg", CONFIG, "--out", str(tmp_path / "port"), *opts]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and "shards.json" in names
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "port" / n).read_bytes(), n
