"""The sharded checkpoint backend (``TPU.CKPT_BACKEND orbax``: a
``torch.distributed.checkpoint`` directory, ``utils/checkpoint.py``) on
the CPU, at tiny3d.

* Round trip and resume in one process: a directory written after 2 fused
  MoCo steps loads into a fresh state bit for bit, and 2 more steps from
  it equal a straight run bit for bit.
* Written by 2 gloo ranks (each writes a share), loaded by 1 process and
  by 2 ranks: the state bit for bit.
* ``TPU.ASYNC_CKPT``: the state is the one at the call, at most one save
  is in flight, and ``wait_for_async_checkpoints`` drains it; on 2 gloo
  ranks the trainer runs an epoch's steps while a save is in flight and
  drains the last save before it returns, and that save reloads bit for
  bit.
* The saver's promotion of a directory to ``model_best`` against JAX's
  saver (``.dcp`` where JAX writes ``.orbax``, mapped as
  ``test_saver_matches_jax`` maps the file suffixes), and the port's
  checkpoint readers on a directory.
"""

import glob
import json
import os

import numpy as np
import torch

from _torch_dist_util import async_save_worker, dcp_worker, port_cfg, run_ranks, state_arrays
from video_graph_ssl_tpu_torch import train_video_contrast_dis as train
from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
from video_graph_ssl_tpu_torch.engine.pretrain import make_fused_pretrain_step
from video_graph_ssl_tpu_torch.models.build import create_video_model, create_visual_model
from video_graph_ssl_tpu_torch.utils import checkpoint as ckpt
from video_graph_ssl_tpu_torch.utils import saver as psaver

torch.set_num_threads(1)
B, T = 4, 4


def _state(c, seed=None):
    return create_pretrain_state(c, create_visual_model(c, seed=seed)[0], "cpu")


def _raw_clips(n, seed=0, b=B):
    g = np.random.default_rng(seed)
    return [g.integers(0, 256, (b, 2, T, 20, 20, 3), dtype=np.uint8) for _ in range(n)]


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


def _same(a, b):
    assert ckpt.mismatches(ckpt.checkpoint_payload(a, 0), ckpt.checkpoint_payload(b, 0)) == []


def test_round_trip_and_resume_are_bit_exact(tmp_path):
    c = port_cfg()
    step = make_fused_pretrain_step(c)
    batches = [torch.from_numpy(x) for x in _raw_clips(4, seed=1)]
    straight = _state(c)
    for x in batches:
        last = step(straight, x, 0.1)
    first = _state(c)
    for x in batches[:2]:
        step(first, x, 0.1)
    path = str(tmp_path / "checkpoint_2.dcp")
    ckpt.save_checkpoint_orbax(path, first, epoch=2, best_pred=1.5, extra={"note": "x"})
    assert os.path.isdir(path) and os.path.exists(os.path.join(path, ".metadata"))
    resumed = _state(c, seed=99)
    meta = ckpt.load_checkpoint_any(path, resumed)
    assert meta == {"epoch": 2, "best_pred": 1.5, "step": 2, "note": "x"}
    with open(path + ".meta.json") as f:
        assert json.load(f) == meta
    _same(first, resumed)
    assert len(resumed.optimizer.state) == len(list(first.model.parameters()))
    payload = ckpt.read_payload(path)
    assert payload["optimizer"]["param_groups"] == first.optimizer.state_dict()["param_groups"]
    for x in batches[2:]:
        again = step(resumed, x, 0.1)
    assert torch.equal(last["loss"], again["loss"])
    _same(straight, resumed)


def test_written_by_two_ranks_loads_in_one_and_on_two(tmp_path):
    clips = _raw_clips(1, seed=2, b=2 * B)[0]
    directory = str(tmp_path / "ranks.dcp")
    wrote = run_ranks(dcp_worker, 2, tmp_path, directory, clips)
    shards = sorted(glob.glob(os.path.join(directory, "*.distcp")))
    assert len(shards) == 2 and all(os.path.getsize(s) > 0 for s in shards)
    for k, v in wrote[1]["state"].items():       # the ranks' states are one
        assert np.array_equal(v, wrote[0]["state"][k]), k
    one = _state(port_cfg(), seed=99)
    assert ckpt.load_checkpoint_any(directory, one)["epoch"] == 2
    got = state_arrays(one)
    assert sorted(got) == sorted(wrote[0]["state"])
    for k, v in wrote[0]["state"].items():
        assert np.array_equal(got[k], v) and got[k].dtype == v.dtype, k
    (tmp_path / "again").mkdir()
    loaded = run_ranks(dcp_worker, 2, tmp_path / "again", directory, None, True)
    for r in loaded:
        for k, v in wrote[0]["state"].items():
            assert np.array_equal(r["state"][k], v), k


def test_async_save_snapshots_at_the_call_and_drains(tmp_path):
    c = port_cfg()
    step = make_fused_pretrain_step(c)
    state = _state(c)
    x = [torch.from_numpy(a) for a in _raw_clips(3, seed=3)]
    step(state, x[0], 0.1)
    first = str(tmp_path / "a.dcp")
    want = _clone(ckpt.checkpoint_payload(state, 1))
    ckpt.save_checkpoint_orbax(first, state, epoch=1, async_save=True)
    assert len(ckpt._ASYNC_SAVES) == 1
    step(state, x[1], 0.1)                       # the state moves on meanwhile
    second = str(tmp_path / "b.dcp")
    ckpt.save_checkpoint_orbax(second, state, epoch=2, async_save=True)
    assert len(ckpt._ASYNC_SAVES) == 1           # the first was drained
    ckpt.wait_for_async_checkpoints()
    assert ckpt._ASYNC_SAVES == []
    back = _state(c, seed=6)
    ckpt.load_checkpoint_any(first, back)
    assert ckpt.mismatches(ckpt.checkpoint_payload(back, 1), want) == []
    back2 = _state(c, seed=6)
    ckpt.load_checkpoint_any(second, back2)
    _same(back2, state)
    assert ckpt.mismatches(ckpt.checkpoint_payload(back2, 0),
                           ckpt.checkpoint_payload(back, 0)) != []


def test_async_saves_on_two_ranks_reload_bit_for_bit(tmp_path):
    """The pretrain trainer on 2 gloo ranks, 2 epochs of 4 steps, an async
    directory saved after each: epoch 1's steps (DDP's and the BN's
    all-reduces) run while checkpoint_1 is in flight, and checkpoint_2 is
    drained before the run returns.  Both load in one process: the last
    into the ranks' final state bit for bit."""
    from test_torch_trainer import CONFIG, SYNTHETIC

    opts = SYNTHETIC + ["TPU.CKPT_BACKEND", "orbax", "TPU.ASYNC_CKPT", "True",
                        "SOLVER.MAX_EPOCHS", "2", "CHECKPOINT.CHECKPOINT_INTERVAL", "1"]
    ranks = run_ranks(async_save_worker, 2, tmp_path, CONFIG, opts, str(tmp_path / "run"))
    assert [r["in_flight"] for r in ranks] == [0, 0]
    assert [r["step"] for r in ranks] == [8, 8]
    want = ranks[0]["state"]
    for k, v in ranks[1]["state"].items():
        assert np.array_equal(v, want[k]), k
    c = train.load_config(CONFIG, opts)
    exp = ranks[0]["experiment_dir"]
    for n in (1, 2):
        back = create_pretrain_state(c, create_visual_model(c, seed=99)[0], "cpu")
        meta = ckpt.load_checkpoint_any(os.path.join(exp, f"checkpoint_{n}.dcp"), back)
        assert (meta["epoch"], meta["step"]) == (n, 4 * n)
    got = state_arrays(back)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v) and got[k].dtype == v.dtype, k


def test_saver_promotes_a_directory_like_jax(tmp_path, monkeypatch):
    """The same saves through both savers under the sharded backend:
    numbering, best_pred.txt, the promotion of ``model_best`` (directory
    and meta file), ``parameters.txt``."""
    from video_graph_ssl_tpu.utils import checkpoint as jckpt
    from video_graph_ssl_tpu.utils.saver import Saver as JaxSaver

    from test_torch_trainer import CONFIG, SYNTHETIC, _jax_cfg

    def fake_save(path, state, *a, **k):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "payload"), "w") as f:
            f.write(state)
        with open(path + ".meta.json", "w") as f:
            f.write(state)

    monkeypatch.setattr(jckpt, "save_checkpoint_orbax", fake_save)
    monkeypatch.setattr(psaver, "save_checkpoint_orbax", fake_save)
    opts = ["TPU.CKPT_BACKEND", "orbax", "TPU.ASYNC_CKPT", "True"]
    pc = train.load_config(CONFIG, SYNTHETIC + opts)
    jc = _jax_cfg(SYNTHETIC + opts)
    listing = {}
    for name, saver_cls, c, ext, dext in (("port", psaver.Saver, pc, ".pth.tar", ".dcp"),
                                          ("jax", JaxSaver, jc, ".msgpack", ".orbax")):
        base = str(tmp_path / name)
        for run, preds in enumerate(([3.0, 5.0], [4.0], [6.0, 2.0])):
            s = saver_cls(c, base_dir=base)
            s.save_experiment_config()
            for k, p in enumerate(preds):
                path = s.save_checkpoint(f"{run}:{k}", epoch=k, best_pred=p, is_best=True,
                                         filename=f"checkpoint{ext}")
                assert path.endswith(dext)
        files = {}
        for path in sorted(glob.glob(os.path.join(base, "**", "*"), recursive=True)):
            if os.path.isfile(path):
                files[os.path.relpath(path, base).replace(dext, ".ckpt")] = open(path).read()
        listing[name] = files
    assert listing["port"] == listing["jax"]
    best = sorted(k for k in listing["port"] if "model_best" in k)
    assert [os.path.basename(k) for k in best] == ["model_best.ckpt.meta.json", "payload"]
    assert all(listing["port"][k] == "2:0" for k in best)


def test_every_reader_takes_a_directory(tmp_path):
    """``load_params_only`` (video_retrieval, cam, export_model),
    ``read_payload`` (train_ds's surgery, the converter's ``--checkpoint``),
    ``MODEL.PRETRAIN_PATH`` and the surgery itself; ``load_checkpoint_state``
    (resume, test_ds) is the round trip above."""
    c = port_cfg()
    state = _state(c)
    path = str(tmp_path / "checkpoint_1.dcp")
    ckpt.save_checkpoint_orbax(path, state, epoch=1)
    sd, meta = ckpt.load_params_only(path)
    assert meta["epoch"] == 1
    want = state.model.state_dict()
    assert sorted(sd) == sorted(want) and all(torch.equal(sd[k], want[k]) for k in want)
    backbone = train.load_backbone_state_dict(path)
    assert all(torch.equal(v, want["model.encoder.base_model." + k])
               for k, v in backbone.items())
    video, _ = create_video_model(c)
    ckpt.transfer_encoder_params(sd, video)
    assert torch.equal(video.base_model.stage0.conv.weight,
                       want["model.encoder.base_model.stage0.conv.weight"])
    assert ckpt.read_payload(path)["epoch"] == 1     # the converter's --checkpoint


def test_new_modules_import_neither_jax_nor_orbax():
    """The S2D stem, the ring, the sharded backend and the host tools load
    with torch alone."""
    import subprocess
    import sys
    import textwrap

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {repo!r})
        from video_graph_ssl_tpu_torch import prepare_data
        from video_graph_ssl_tpu_torch.data import video_io
        from video_graph_ssl_tpu_torch.parallel import graph_aug_sequence_parallel, sequence
        from video_graph_ssl_tpu_torch.utils import checkpoint, ckpt_convert, saver
        from video_graph_ssl_tpu_torch.models.s3d import S3D, stem_params_to_s2d
        S3D(stem_s2d="full")
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',
                                            'video_graph_ssl_tpu', 'tools'))
        assert not bad, bad
        print('ok')
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
