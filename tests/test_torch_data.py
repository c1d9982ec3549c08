"""The port's host data path against the JAX package's, on the CPU.

Each test feeds both packages the same inputs (made from a seed with numpy,
or JPEG frames the test writes) and asks for equal outputs:
split parsing, every frame sampler over many seeded draws, ``load_clip``
through cv2, PIL and the native pool, shard stores (byte-equal files, and
each package reading the other's), dataset items, the ``Loader``'s batches
over two epochs, the three loader factories, and the meters.  The
synthetic source's batch order through the port's trainer equals the JAX
package's ``Loader``.
"""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from video_graph_ssl_tpu.config import cfg as jax_cfg
from video_graph_ssl_tpu.data import build as jbuild
from video_graph_ssl_tpu.data import datasets as jds
from video_graph_ssl_tpu.data import decode as jdecode
from video_graph_ssl_tpu.data import pipeline as jpipe
from video_graph_ssl_tpu.data import records as jrec
from video_graph_ssl_tpu.data import samplers as jsamp
from video_graph_ssl_tpu.data import shards as jshards
from video_graph_ssl_tpu.data import synthetic as jsyn
from video_graph_ssl_tpu.utils import meters as jmeters
from video_graph_ssl_tpu_torch.config import cfg as port_cfg
from video_graph_ssl_tpu_torch.data import build as pbuild
from video_graph_ssl_tpu_torch.data import datasets as pds
from video_graph_ssl_tpu_torch.data import decode as pdecode
from video_graph_ssl_tpu_torch.data import pipeline as ppipe
from video_graph_ssl_tpu_torch.data import records as prec
from video_graph_ssl_tpu_torch.data import samplers as psamp
from video_graph_ssl_tpu_torch.data import shards as pshards
from video_graph_ssl_tpu_torch.data import synthetic as psyn
from video_graph_ssl_tpu_torch.utils import meters as pmeters

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (18, 24)
LENGTHS = {"vid_a": 7, "vid_b": 5, "vid_c": 9, "vid_d": 12, "vid_e": 3}


def _write_frames(root, name, n, seed):
    d = os.path.join(root, name)
    os.makedirs(d)
    g = np.random.default_rng(seed)
    for i in range(1, n + 1):
        cv2.imwrite(os.path.join(d, f"img_{i:05d}.jpg"),
                    g.integers(0, 256, (20, 28, 3), np.uint8))
        for ax in ("x", "y"):
            cv2.imwrite(os.path.join(d, f"flow_{ax}_{i:05d}.jpg"),
                        g.integers(0, 256, (20, 28), np.uint8))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """JPEG frame folders and a split file, written here."""
    root = str(tmp_path_factory.mktemp("frames"))
    for i, (name, n) in enumerate(LENGTHS.items()):
        _write_frames(root, name, n, seed=i)
    split = os.path.join(root, "split.txt")
    with open(split, "w") as f:
        for i, (name, n) in enumerate(LENGTHS.items()):
            f.write(f"{name} {n} {i % 3}\n\n")
    return root, split


def _frame_source(directory, idx):
    v = sum(map(ord, os.path.basename(directory)))
    return np.random.default_rng((v, idx)).integers(0, 256, (*CANVAS, 3), np.uint8)


@pytest.fixture(scope="module")
def stores(corpus, tmp_path_factory):
    """The same store written by each package from the JPEG frames."""
    root, split = corpus
    out = {}
    for name, mod in (("jax", jshards), ("port", pshards)):
        d = str(tmp_path_factory.mktemp(f"store_{name}"))
        mod.write_shard_store(root, [split], d, CANVAS, shard_bytes=20_000)
        out[name] = d
    return out


def _equal_items(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------------------------------- #
def test_parse_split_equal(corpus):
    _, split = corpus
    ours, ref = prec.parse_split(split), jrec.parse_split(split)
    assert [(r.path, r.num_frames, r.label) for r in ours] == \
        [(r.path, r.num_frames, r.label) for r in ref]
    assert len(ours) == len(LENGTHS)


SAMPLERS = {
    "uniform": lambda m, n, L, nl, g: m.sample_indices_uniform(n, L, nl, g),
    "uniform_contrast": lambda m, n, L, nl, g: m.sample_indices_uniform(
        n, L, nl, g, contrast=True),
    "val": lambda m, n, L, nl, g: m.val_indices(n, L, nl),
    "val_contrast": lambda m, n, L, nl, g: m.val_indices(n, L, nl, contrast=True),
    "dense": lambda m, n, L, nl, g: m.dense_indices(n, L, 1 + nl, g),
    "adver": lambda m, n, L, nl, g: m.adver_indices(n, L, 1 + nl % 3, nl, g),
    "test": lambda m, n, L, nl, g: m.test_indices(n, L, nl),
    "nclips": lambda m, n, L, nl, g: m.nclips_test_indices(n, L, 1 + nl, 1 + nl % 4),
}


def _draw(fn, module, *args):
    """The sampler's indices, or the type of the error it raises (some
    arguments, e.g. new_length above num_frames for ``adver``, raise in
    both packages)."""
    try:
        return fn(module, *args)
    except ValueError as e:
        return type(e)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
@settings(max_examples=150, deadline=None, database=None, derandomize=True)
@given(num_frames=st.integers(1, 400), video_length=st.integers(1, 32),
       new_length=st.integers(1, 5), seed=st.integers(0, 2 ** 32 - 1))
def test_sampler_matches_jax(name, num_frames, video_length, new_length, seed):
    fn = SAMPLERS[name]
    ours, ref = (_draw(fn, m, num_frames, video_length, new_length,
                       np.random.default_rng(seed)) for m in (psamp, jsamp))
    if isinstance(ref, type):
        assert ours is ref
        return
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("pre_load", ["cv2", "PIL"])
@pytest.mark.parametrize("modality,new_length,canvas", [
    ("RGB", 1, CANVAS), ("RGB", 3, CANVAS), ("RGB", 1, None), ("Flow", 2, CANVAS)])
def test_load_clip_matches_jax(corpus, pre_load, modality, new_length, canvas):
    root, _ = corpus
    tmpl = "flow_{}_{:05d}.jpg" if modality == "Flow" else "img_{:05d}.jpg"
    kw = dict(directory=os.path.join(root, "vid_a"), image_tmpl=tmpl,
              indices=[1, 4, 6, 7], pre_load=pre_load, canvas_hw=canvas,
              modality=modality, new_length=new_length, num_frames=7)
    ours, ref = pdecode.load_clip(**kw), jdecode.load_clip(**kw)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_load_clip_without_a_codec_names_them(corpus, monkeypatch):
    root, _ = corpus
    monkeypatch.setattr(pdecode, "_cv2", lambda: None)
    monkeypatch.setattr(pdecode, "_pil_image", lambda: None)
    with pytest.raises(ImportError, match="cv2.*PIL"):
        pdecode.load_clip(os.path.join(root, "vid_a"), "img_{:05d}.jpg", [1, 2],
                          "cv2", CANVAS)


def _native_pools():
    from video_graph_ssl_tpu.data.native import native_jpeg_available as jax_ok
    from video_graph_ssl_tpu_torch.data.native import native_jpeg_available as port_ok

    if not (jax_ok() and port_ok()):
        pytest.skip("g++/libjpeg unavailable")


@pytest.mark.parametrize("new_length", [1, 3])
def test_native_pool_matches_jax(corpus, new_length):
    _native_pools()
    root, _ = corpus
    kw = dict(directory=os.path.join(root, "vid_d"), image_tmpl="img_{:05d}.jpg",
              indices=[1, 5, 11, 12], pre_load="native", canvas_hw=CANVAS,
              new_length=new_length, num_frames=12)
    ours, ref = pdecode.load_clip(**kw), jdecode.load_clip(**kw)
    assert ours.shape == (4, *CANVAS, 3 * new_length)
    np.testing.assert_array_equal(ours, ref)


def test_native_pool_builds_into_the_build_dir():
    _native_pools()
    from video_graph_ssl_tpu_torch.data.native import jpeg_pool

    so = jpeg_pool.library_path()
    assert so.exists() and so.parent.name == "_build"
    assert so.parent.parent.name == "video_graph_ssl_tpu_torch"


def test_native_pool_raises_when_it_did_not_build(corpus, monkeypatch):
    """No fallback: a failed build raises with its error, and the native
    path of load_clip does not move to cv2."""
    from video_graph_ssl_tpu_torch.data.native import jpeg_pool

    root, _ = corpus
    monkeypatch.setattr(jpeg_pool, "_lib", None)
    monkeypatch.setattr(jpeg_pool, "_lib_err", "CalledProcessError: g++ not found")
    monkeypatch.setattr(pdecode, "_NATIVE_POOL", None)
    with pytest.raises(RuntimeError, match="did not build.*g\\+\\+ not found"):
        pdecode.load_clip(os.path.join(root, "vid_a"), "img_{:05d}.jpg", [1, 2],
                          "native", CANVAS)


# --------------------------------------------------------------------------- #
def _store_files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def test_store_from_jpeg_frames_is_byte_equal(stores):
    ours, ref = _store_files(stores["port"]), _store_files(stores["jax"])
    assert sorted(ours) == sorted(ref) and len(ours) > 2   # several shards
    for n in ref:
        assert ours[n] == ref[n], n


def test_store_from_frame_source_is_byte_equal(corpus, tmp_path):
    _, split = corpus
    dirs = []
    for mod in (jshards, pshards):
        d = str(tmp_path / mod.__name__.split(".")[0])
        meta = mod.write_shard_store("/unused", [split, split], d, CANVAS,
                                     shard_bytes=30_000, frame_source=_frame_source)
        dirs.append(d)
    assert meta["num_shards"] > 1
    assert _store_files(dirs[0]) == _store_files(dirs[1])


@pytest.mark.parametrize("reader,writer", [("port", "jax"), ("jax", "port")])
def test_each_package_reads_the_others_store(stores, reader, writer):
    store = (pshards if reader == "port" else jshards).ShardStore(stores[writer])
    own = (pshards if reader == "jax" else jshards).ShardStore(stores[reader])
    for name, n in LENGTHS.items():
        assert name in store and store.num_frames(name) == n
        for nl in (1, 3):
            idx = np.minimum(np.arange(1, n + 1, 2), n)
            np.testing.assert_array_equal(
                store.load_clip(name, idx, new_length=nl, num_frames=n),
                own.load_clip(name, idx, new_length=nl, num_frames=n))


# --------------------------------------------------------------------------- #
def _dataset_pair(kind, **kw):
    return (getattr(pds, kind)(**kw), getattr(jds, kind)(**kw))


# the contrastive uniform sampler may ask for frame num_frames + 1 (the
# reference's VisualDataset arithmetic), which a shard store clamps and a
# frame folder lacks, in both packages: JPEG folders take dense sampling
@pytest.mark.parametrize("source,sample_type,jitter", [
    ("shard", "dense", True), ("shard", "uniform", False), ("shard", "uniform", True),
    ("cv2", "dense", True), ("cv2", "dense", False)])
def test_contrastive_dataset_items_equal(corpus, stores, source, sample_type, jitter):
    root, split = corpus
    ours, ref = _dataset_pair(
        "ContrastiveDataset", root_path=stores["port"] if source == "shard" else root,
        list_file=split, video_length=4, frame_interval=2, sample_type=sample_type,
        pre_load=source, canvas_hw=CANVAS, temporal_jitter=jitter)
    assert len(ours) == len(ref) == len(LENGTHS)
    for i in range(len(ref)):
        a = ours.__getitem__(i, rng=np.random.default_rng((3, i)))
        b = ref.__getitem__(i, rng=np.random.default_rng((3, i)))
        assert a["clips"].shape == (2, 4, *CANVAS, 3)
        _equal_items(a, b)


@pytest.mark.parametrize("mode", ["train_uniform", "train_dense", "val", "test_clips",
                                  "test_center", "adver"])
def test_frame_dataset_items_equal(corpus, stores, mode):
    root, split = corpus
    kw = dict(root_path=stores["port"], list_file=split, video_length=3,
              sample_rate=2, pre_load="shard", canvas_hw=CANVAS, num_clips=2,
              nsamples=2)
    kw.update({"train_uniform": {}, "train_dense": {"sample_type": "dense"},
               "val": {"random_shift": False},
               "test_clips": {"test_mode": True},
               "test_center": {"test_mode": True, "num_clips": 0},
               "adver": {"use_adver": True}}[mode])
    ours, ref = _dataset_pair("FrameDataset", **kw)
    for i in range(len(ref)):
        _equal_items(ours.__getitem__(i, rng=np.random.default_rng((5, i))),
                     ref.__getitem__(i, rng=np.random.default_rng((5, i))))


# --------------------------------------------------------------------------- #
def _loaders(**kw):
    out = []
    for pipe, syn in ((ppipe, psyn), (jpipe, jsyn)):
        ds = syn.SyntheticContrastiveDataset(n_data=27, video_length=2,
                                             canvas_hw=(4, 6), num_classes=5, seed=3)
        out.append(pipe.Loader(ds, **{"batch_size": 4, "num_workers": 2,
                                      "seed": 11, **kw}))
    return out


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
def test_loader_batches_equal_over_two_epochs(shuffle, drop_last):
    ours, ref = _loaders(shuffle=shuffle, drop_last=drop_last)
    assert len(ours) == len(ref) == (6 if drop_last else 7)
    for epoch in (0, 1):
        a, b = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(a) == len(b) == len(ref)
        for x, y in zip(a, b):
            _equal_items(x, y)
    if shuffle:
        assert not np.array_equal(a[0]["index"], list(ours.epoch(0))[0]["index"])


def test_loader_early_break_shuts_down():
    ours, ref = _loaders(prefetch=1)
    it = ours.epoch(0)
    _equal_items(next(it), next(iter(ref.epoch(0))))
    it.close()                         # must not hang
    assert len(list(ours.epoch(1))) == 6


def test_loader_raises_a_worker_error():
    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, index, rng=None):
            raise ValueError(f"item {index}")

    with pytest.raises(ValueError, match="item"):
        list(ppipe.Loader(Broken(), batch_size=4).epoch(0))


def test_to_device_on_the_cpu_is_the_array():
    a = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    t = ppipe.to_device(a, torch.device("cpu"))
    assert t.dtype == torch.uint8 and np.array_equal(t.numpy(), a)


# --------------------------------------------------------------------------- #
TINY = ["MODEL.BACKBONE", "tiny3d", "MODEL.AUG_FLAG", "True", "DATASET.NUM_CLASS", "5",
        "DATALOADER.BATCH_SIZE", "4", "DATALOADER.NUM_WORKERS", "2",
        "TEST.BATCH_SIZE", "3", "INPUT.VIDEO_LENGTH", "3",
        "INPUT.SCALE_SIZE", f"[{CANVAS[0]}, {CANVAS[1]}]", "INPUT.BASE_SIZE", "[16, 16]",
        "CONTRAST.NCE_K", "16", "CROSS.FEAT_DIM", "32", "MODEL.SEED", "4"]


def _cfgs(opts):
    out = []
    for base in (port_cfg, jax_cfg):
        c = base.clone()
        c.merge_from_file(os.path.join(REPO, "configs", "visual_moco.yaml"))
        c.merge_from_list(TINY + list(opts))
        out.append(c)
    return out


def _source_opts(source, corpus, stores):
    if source == "synthetic":
        return ["DATASET.SOURCE", "synthetic"]
    _, split = corpus
    return ["DATASET.SOURCE", "frames", "INPUT.PRE_LOAD", "shard",
            "DATASET.VISUAL_ROOT_DIR", stores["port"], "DATASET.TRAIN_SPLIT", split,
            "DATASET.VALIDATION_SPLIT", split, "INPUT.SAMPLE_RATE", "2"]


def _first_batches(ours, ref, epochs=(0,)):
    for e in epochs:
        a, b = list(ours.epoch(e)), list(ref.epoch(e))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            _equal_items(x, y)


@pytest.mark.parametrize("source", ["synthetic", "shard"])
@pytest.mark.parametrize("factory", ["contrastive", "train", "val", "test"])
def test_loader_factories_match_jax(corpus, stores, source, factory):
    pc, jc = _cfgs(_source_opts(source, corpus, stores))
    if factory == "contrastive":
        (ours, n_ours), (ref, n_ref) = (pbuild.build_video_contrastive_loader(pc),
                                        jbuild.build_video_contrastive_loader(jc))
        assert n_ours == n_ref == len(ref.dataset)
    elif factory == "test":
        ours, ref = pbuild.make_test_loader(pc, 2), jbuild.make_test_loader(jc, 2)
    else:
        ours, ref = (m.make_data_loader(c, is_train=factory == "train")
                     for m, c in ((pbuild, pc), (jbuild, jc)))
    assert (ours.batch_size, ours.shuffle, ours.drop_last, len(ours)) == \
        (ref.batch_size, ref.shuffle, ref.drop_last, len(ref))
    _first_batches(ours, ref)


@pytest.mark.parametrize("nl,modality", [(-1, "RGB"), (-1, "Flow"), (3, "RGB")])
def test_resolve_new_length_matches_jax(nl, modality):
    pc, jc = _cfgs(["INPUT.NEW_LENGTH", str(nl), "INPUT.MODALITY", modality])
    assert pbuild.resolve_new_length(pc) == jbuild.resolve_new_length(jc)


def test_trainer_synthetic_batches_follow_jax_loader_order(tmp_path):
    """The port's trainer feeds the synthetic source through the Loader in
    the JAX package's order: the same batch indices (and clips) over two
    epochs for the same config and seed."""
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer

    pc, jc = _cfgs(["DATASET.SOURCE", "synthetic"])
    pc.freeze()
    trainer = Trainer(pc, device="cpu", run_dir=str(tmp_path))
    ref, _ = jbuild.build_video_contrastive_loader(jc)
    assert len(trainer.train_loader) == len(ref) == 5
    _first_batches(trainer.train_loader, ref, epochs=(0, 1))


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["single", "multi", "three_dim"])
@pytest.mark.parametrize("topk", [(1,), (1, 3), (1, 5)])
def test_accuracy_matches_jax(case, topk):
    g = np.random.default_rng(len(case) * 10 + len(topk))
    out = g.normal(size=(24, 13)).astype(np.float32)
    tgt = {"single": lambda: g.integers(0, 13, size=24),
           "multi": lambda: (g.random(size=(24, 13)) < 0.3).astype(np.float32),
           "three_dim": lambda: (g.random(size=(24, 4, 13)) < 0.2).astype(np.float32),
           }[case]()
    assert pmeters.accuracy(out, tgt, topk) == jmeters.accuracy(out, tgt, topk)


def test_average_precision_and_map_match_jax():
    g = np.random.default_rng(7)
    out = g.normal(size=(30, 6))
    tgt = (g.random(size=(30, 6)) < 0.3).astype(np.float32)
    tgt[:, 2] = 0                               # a class with no positive
    for c in range(6):
        assert pmeters.average_precision(out[:, c], tgt[:, c]) == \
            jmeters.average_precision(out[:, c], tgt[:, c])
    assert pmeters.mean_average_precision(out, tgt) == \
        jmeters.mean_average_precision(out, tgt)


def test_average_meter_matches_jax():
    ours, ref = pmeters.AverageMeter(), jmeters.AverageMeter()
    for v, n in [(2.0, 1), (4.0, 3), (1.0, 2), (np.float32(0.5), 5)]:
        ours.update(v, n)
        ref.update(v, n)
        assert (ours.val, ours.sum, ours.count, ours.avg) == \
            (ref.val, ref.sum, ref.count, ref.avg)
