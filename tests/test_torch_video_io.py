"""The port's video IO (``data/video_io.py``) and data preparation
(``prepare_data.py``) against the JAX package's on the CPU.

JAX's ``tests/test_video_io.py`` and ``tests/test_prepare_data.py`` cases
run through both packages on the same cv2-written videos: the decoded
frames, the float input, the missing file, the cache; ``extract`` then
``split`` give identical frame trees (every JPEG byte for byte) and split
files, and the port's frame dataset reads them.  Without cv2 the port
still imports, and its functions fail as the JAX ones do.
"""

import filecmp
import importlib
import os
import sys

import numpy as np
import pytest

from tools import prepare_data as jax_prep
from video_graph_ssl_tpu.data import video_io as jax_io
from video_graph_ssl_tpu_torch import prepare_data as prep
from video_graph_ssl_tpu_torch.data import video_io

needs_cv2 = pytest.mark.skipif(video_io._cv2() is None, reason="needs cv2")


def _clip(seed: int, n=6, h=48, w=64) -> np.ndarray:
    """The smooth synthetic clip of JAX's tests (survives lossy codecs)."""
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        r = (128 + 100 * np.sin(xx / 9.0 + t / 2.0 + seed)).astype(np.uint8)
        g = (128 + 100 * np.cos(yy / 7.0 - t / 3.0)).astype(np.uint8)
        b = np.full((h, w), (40 * t + 13 * seed) % 255, np.uint8)
        frames.append(np.stack([r, g, b], axis=-1))
    return np.stack(frames, axis=0)


@needs_cv2
@pytest.mark.parametrize("ext", [".avi", ".mp4"])
def test_round_trip_matches_jax(tmp_path, capsys, ext):
    vid = _clip(0, n=8)
    ours, theirs = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
    video_io.write_video(vid, ours, fps=10.0)
    jax_io.write_video(vid, theirs, fps=10.0)
    assert filecmp.cmp(ours, theirs, shallow=False)
    assert capsys.readouterr().out.count("saved video to ") == 2
    back, fps = video_io.load_video(ours)
    want, want_fps = jax_io.load_video(ours)
    assert back.dtype == np.uint8 and back.shape == vid.shape
    assert np.array_equal(back, want) and fps == want_fps == pytest.approx(10.0, abs=0.5)
    assert np.abs(back.astype(np.float32) - vid).mean() < 16.0
    assert video_io.video_info(ours) == jax_io.video_info(ours)
    assert video_io.video_info(ours)["num_frames"] == 8


@needs_cv2
def test_float_input_matches_jax(tmp_path):
    vid = _clip(1, n=4).astype(np.float32) / 255.0
    ours, theirs = str(tmp_path / "p.avi"), str(tmp_path / "j.avi")
    video_io.write_video(vid, ours, fps=5.0)
    jax_io.write_video(vid, theirs, fps=5.0)
    assert filecmp.cmp(ours, theirs, shallow=False)
    assert np.array_equal(video_io._as_uint8_video(vid), jax_io._as_uint8_video(vid))
    back, _ = video_io.load_video(ours)
    assert back is not None and back.shape == (4, 48, 64, 3)


def test_missing_file_returns_none_like_jax(tmp_path, capsys):
    missing = str(tmp_path / "nope.mp4")
    assert video_io.load_video(missing) == (None, None)
    ours = capsys.readouterr().out
    assert jax_io.load_video(missing) == (None, None)
    assert ours == capsys.readouterr().out and "failed to load video" in ours
    for fn in (video_io.video_info, jax_io.video_info):
        with pytest.raises(IOError, match="failed to open"):
            fn(missing)


def test_cache_matches_jax(tmp_path, capsys):
    logs = {}
    for name, mod in (("port", video_io), ("jax", jax_io)):
        calls = []

        (tmp_path / name).mkdir()

        @mod.cache(str(tmp_path / name / "idx.pkl"))
        def build(a, b=2):
            calls.append((a, b))
            return {"val": a + b}

        assert build(1, b=3) == {"val": 4}
        assert build(1, b=3) == {"val": 4}
        assert build(9) == {"val": 4}      # the key is the file, not the args
        assert calls == [(1, 3)]
        logs[name] = capsys.readouterr().out.replace(str(tmp_path / name), "*")
    assert logs["port"] == logs["jax"]
    assert (tmp_path / "port" / "idx.pkl").read_bytes() == \
        (tmp_path / "jax" / "idx.pkl").read_bytes()


@pytest.fixture(scope="module")
def video_tree(tmp_path_factory):
    if video_io._cv2() is None:
        pytest.skip("needs cv2")
    root = tmp_path_factory.mktemp("videos")
    seed = 0
    for cls, vids in {"classA": ["vid_a1", "vid_a2"], "classB": ["vid_b1", "vid_b2"]}.items():
        os.makedirs(root / cls, exist_ok=True)
        for v in vids:
            video_io.write_video(_clip(seed), str(root / cls / f"{v}.avi"), fps=10.0)
            seed += 1
    return root


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_extract_and_split_match_jax(video_tree, tmp_path, capsys):
    trees = {}
    for name, mod in (("port", prep), ("jax", jax_prep)):
        frames, lists = tmp_path / name / "frames", tmp_path / name / "lists"
        assert mod.main(["extract", "--video_root", str(video_tree), "--out_root",
                         str(frames), "--short_side", "32", "--workers", "2"]) == 0
        assert mod.main(["extract", "--video_root", str(video_tree), "--out_root",
                         str(frames), "--skip_existing"]) == 0
        assert mod.main(["split", "--frame_root", str(frames), "--out_dir", str(lists),
                         "--val_frac", "0.5"]) == 0
        official = tmp_path / name / "trainlist01.txt"
        official.write_text("classB/vid_b1.avi 2\nclassA/vid_a2.avi 1\nclassA/missing.avi 1\n")
        assert mod.main(["split", "--frame_root", str(frames), "--out_dir", str(lists),
                         "--official_list", str(official)]) == 0
        assert mod.main(["split", "--frame_root", str(frames), "--out_dir",
                         str(tmp_path / name / "all")]) == 0
        trees[name] = (_tree(frames), _tree(lists), _tree(tmp_path / name / "all"))
        assert mod.main(["extract", "--video_root", str(tmp_path / "empty_dir_missing"),
                         "--out_root", str(frames)]) == 1
    capsys.readouterr()
    for ours, theirs in zip(trees["port"], trees["jax"]):
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            assert ours[k] == theirs[k], k
    frames = trees["port"][0]
    assert len([k for k in frames if k.startswith(os.path.join("classA", "vid_a1"))]) == 6
    assert os.path.join("classA", "vid_a1", "img_00001.jpg") in frames
    assert os.path.join("classA", "vid_a1", "img_00000.jpg") not in frames
    assert trees["port"][1]["trainlist01_frames.txt"] == b"classB/vid_b1 6 1\nclassA/vid_a2 6 0\n"
    assert prep.scan_frame_root(str(tmp_path / "port" / "frames"), "img_{:05d}.jpg") == \
        jax_prep.scan_frame_root(str(tmp_path / "jax" / "frames"), "img_{:05d}.jpg")
    for tmpl in ("img_{:05d}.jpg", "flow_x_{:05d}.jpg"):
        assert prep._tmpl_regex(tmpl).pattern == jax_prep._tmpl_regex(tmpl).pattern
    with pytest.raises(ValueError):
        prep._tmpl_regex("no_field.jpg")

    # the port's frame dataset reads the output
    from video_graph_ssl_tpu_torch.data.datasets import FrameDataset
    from video_graph_ssl_tpu_torch.data.decode import load_image

    root = tmp_path / "port"
    assert min(load_image(str(root / "frames" / "classA" / "vid_a1" / "img_00001.jpg"))
               .shape[:2]) == 32
    ds = FrameDataset(root_path=str(root / "frames"), list_file=str(root / "lists" / "train.txt"),
                      video_length=4, sample_type="uniform", sample_rate=1, modality="RGB",
                      image_tmpl="img_{:05d}.jpg", pre_load="cv2", canvas_hw=(32, 40),
                      random_shift=True, test_mode=False, new_length=1)
    item = ds.__getitem__(0, rng=np.random.default_rng(0))
    assert item["clips"].shape == (4, 32, 40, 3) and item["clips"].dtype == np.uint8
    assert int(item["label"]) in (0, 1)


def test_the_port_imports_without_cv2(tmp_path, monkeypatch, capsys):
    """With cv2 unimportable (and no ffmpeg/ffprobe on PATH) the modules
    import; ``load_video`` reports and returns (None, None), the writer and
    ``video_info`` raise JAX's RuntimeErrors."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    io2 = importlib.reload(video_io)
    try:
        importlib.reload(prep)
        assert io2.load_video(str(tmp_path / "x.avi")) == (None, None)
        assert "cv2 unavailable" in capsys.readouterr().out
        with pytest.raises(RuntimeError, match="write_video needs cv2 or ffmpeg"):
            io2.write_video(_clip(0, n=2), str(tmp_path / "x.avi"))
        with pytest.raises(RuntimeError, match="video_info needs cv2 or ffprobe"):
            io2.video_info(str(tmp_path / "x.avi"))
    finally:
        monkeypatch.undo()
        importlib.reload(video_io)
        importlib.reload(prep)
