"""The port's downstream augmentation against the JAX package on the CPU.

Tolerance: max|port - JAX| / max|JAX| <= 1e-5, both in fp32.  The JAX
reference runs op by op (not under ``jax.jit``): XLA's fused program of the
batched ``train`` chain rounds its resize weights otherwise, and at a
128x171 canvas it sits 1.3e-4 (absolute, normalised pixels) from the same
function run op by op, where the port sits within 1e-6 of both that and a
float64 evaluation of the same weights.

* ``resize_clip`` (``jax.image.resize``, linear, antialias on): its weight
  matrices against JAX's ``compute_weight_mat`` and the resized clips, at
  an up-scale, the identity and two down-scale ratios (100 -> 128,
  128 -> 128, 171 -> 128, 256 -> 128).
* The MultiScaleCrop resize (``scale_and_translate``, no antialias) at
  every crop size of a 128x128 canvas; ``msc_crop_pairs`` equal to JAX's.
* The ``train`` chain with JAX's draws (size pair, offset, flip) injected;
  the ``eval`` chain; ``multi_crop_eval`` for 1, 3, 5, 6 and 10 crops.
* ``make_batch_augment_fn(cfg, 'train')``: its draws are the generator's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jscale

from video_graph_ssl_tpu.config import cfg as jax_cfg
from video_graph_ssl_tpu.data import transforms_device as jtd
from video_graph_ssl_tpu_torch.data import transforms_device as ttd

torch.set_num_threads(1)
TOL = 1e-5
MEAN, STD = tuple(jax_cfg.INPUT.MEAN), tuple(jax_cfg.INPUT.STD)


def rel_max(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jax_weights(m, n, scale, translation, antialias):
    """JAX's (out, in) weight matrix of one axis."""
    w = jscale.compute_weight_mat(m, n, scale, translation,
                                  jscale._kernels[jscale.ResizeMethod.LINEAR], antialias)
    return np.asarray(w).T


def _clips(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("size", [100, 128, 171, 256])
def test_resize_clip_matches_jax(size):
    w = ttd.resize_weights(size, 128, torch.zeros(1), torch.tensor([float(size)]),
                           antialias=True)[0]
    if size != 128:   # JAX skips an axis whose size does not change
        assert rel_max(w, _jax_weights(size, 128, 128 / size, 0.0, True)) < TOL
    else:
        assert torch.equal(w, torch.eye(128))
    x = _clips((2, 3, size, size, 3))
    ref = np.stack([np.asarray(jtd.resize_clip(jnp.asarray(c, jnp.float32), (128, 128)))
                    for c in x])
    ours = ttd.resize_clip(torch.from_numpy(x), (128, 128))
    assert ours.dtype == torch.float32
    assert rel_max(ours, ref) < TOL


def test_msc_pairs_and_crop_weights_match_jax():
    pairs = ttd.msc_crop_pairs(128, 128, (112, 112))
    assert pairs == jtd.msc_crop_pairs(128, 128, (112, 112))
    for w, h in pairs:
        for start, length in ((0, w), (128 - h, h), ((128 - w) // 2, w)):
            ours = ttd.resize_weights(128, 112, torch.tensor([start]),
                                      torch.tensor([length]))[0]
            ref = _jax_weights(128, 112, 112 / length, -start * 112 / length, False)
            assert rel_max(ours, ref) < TOL, (start, length)


def _jax_train_draws(key, n, n_pairs):
    """The (pair, offset, flip) draws of JAX's vmapped ``train_augment``."""
    pair, off, flip = [], [], []
    for k in jax.random.split(key, n):
        k1, k2 = jax.random.split(k)
        kp, ko = jax.random.split(k1)
        pair.append(int(jax.random.randint(kp, (), 0, n_pairs)))
        off.append(int(jax.random.randint(ko, (), 0, 13)))
        flip.append(bool(jax.random.uniform(k2) < 0.5))
    return ttd.TrainParams(torch.tensor(pair), torch.tensor(off), torch.tensor(flip))


@pytest.mark.parametrize("canvas,out", [((40, 40), (32, 32)), ((128, 171), (112, 112))])
def test_train_chain_with_jax_draws_matches_jax(tiny_cfg, canvas, out):
    c = tiny_cfg.clone()
    c.INPUT.BASE_SIZE = list(out)
    c.INPUT.SCALE_SIZE = list(canvas)
    x = _clips((12, 2, *canvas, 3), seed=1)
    key = jax.random.key(7)
    ref = np.asarray(jtd.make_batch_augment_fn(c, "train")(key, jnp.asarray(x)))
    p = _jax_train_draws(key, x.shape[0], len(ttd.msc_crop_pairs(*canvas, out)))
    assert p.flip.any() and not p.flip.all() and len(set(p.offset.tolist())) > 3
    ours = ttd.apply_train_augment(torch.from_numpy(x), p, out, MEAN, STD)
    assert ours.dtype == torch.float32
    assert rel_max(ours, ref) < TOL


def test_eval_chain_matches_jax(tiny_cfg):
    c = tiny_cfg.clone()
    c.INPUT.SCALE_SIZE = [36, 40]
    c.INPUT.CROP_SIZE = [32, 32]
    x = _clips((3, 4, 40, 52, 3), seed=2)
    ref = np.asarray(jtd.make_batch_augment_fn(c, "eval")(jnp.asarray(x)))
    ours = ttd.make_batch_augment_fn(c, "eval")(torch.from_numpy(x))
    assert ours.shape == (3, 4, 32, 32, 3)
    assert rel_max(ours, ref) < TOL


@pytest.mark.parametrize("n_crops", ttd.N_CROPS)
def test_multi_crop_eval_matches_jax(n_crops):
    x = _clips((2, 4, 40, 52, 3), seed=3)
    ref = np.stack([np.asarray(jtd.multi_crop_eval(jnp.asarray(c), (36, 48), (32, 32),
                                                   n_crops, MEAN, STD)) for c in x])
    ours = ttd.multi_crop_eval(torch.from_numpy(x), (36, 48), (32, 32), n_crops, MEAN, STD)
    assert ours.shape == (2, n_crops, 4, 32, 32, 3)
    assert rel_max(ours, ref) < TOL
    if n_crops in (6, 10):
        half = n_crops // 2
        torch.testing.assert_close(ours[:, half:], ours[:, :half].flip(4), rtol=0, atol=0)


def test_train_augment_fn_draws_from_the_generator(tiny_cfg):
    c = tiny_cfg.clone()
    fn = ttd.make_batch_augment_fn(c, "train")
    x = torch.from_numpy(_clips((8, 4, 20, 20, 3), seed=4))

    def run(clips, seed=11):
        return fn(torch.Generator().manual_seed(seed), clips)

    full = run(x)
    assert full.shape == (8, 4, 16, 16, 3) and full.dtype == torch.float32
    assert torch.equal(run(x), full) and not torch.equal(run(x, seed=12), full)
    p = ttd.draw_train_params(8, torch.Generator().manual_seed(11), "cpu",
                              len(ttd.msc_crop_pairs(20, 20, (16, 16))))
    torch.testing.assert_close(ttd.apply_train_augment(x, p, (16, 16), MEAN, STD), full,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown augment kind"):
        ttd.make_batch_augment_fn(c, "nope")
