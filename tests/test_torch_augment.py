"""The port's on-device SSL augmentation against the JAX package, fp32.

The port draws the chain's random parameters apart from applying them, so
these tests derive the exact values the JAX chain draws from a key (crop
boxes, jitter factors and flags, jitter orders, blur sigmas, flips), feed
them to the port's ``apply_ssl_augment``, and compare with the JAX
``make_batch_augment_fn(cfg, 'ssl')`` run on the same key and clips.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_graph_ssl_tpu.data import transforms_device as jtd
from video_graph_ssl_tpu_torch.data import transforms_device as ttd

torch.set_num_threads(1)
B, V, T = 4, 2, 2


def _jax_draws(key, n, canvas_hw, flip_p, attempts=10) -> ttd.SSLParams:
    """The parameters ``make_batch_augment_fn(cfg, 'ssl')`` draws from
    ``key`` for ``n`` clip-views (the key splits of ``ssl_augment_cf``)."""
    H, W = canvas_hw
    k_perm, key = jax.random.split(key)
    perm_ids = jax.random.randint(k_perm, (ttd.n_jitter_groups(n),), 0,
                                  len(ttd.JITTER_PERMS))
    rows = []
    for clip_key in jax.random.split(key, n):
        ks = jax.random.split(clip_key, 7)
        k_area, k_ratio, k_i, k_j = jax.random.split(ks[0], 4)
        target = jax.random.uniform(k_area, (attempts,), minval=0.2,
                                    maxval=1.0) * float(H * W)
        aspect = jnp.exp(jax.random.uniform(k_ratio, (attempts,),
                                            minval=math.log(3 / 4),
                                            maxval=math.log(4 / 3)))
        ws = np.asarray(jnp.round(jnp.sqrt(target * aspect)).astype(jnp.int32))
        hs = np.asarray(jnp.round(jnp.sqrt(target / aspect)).astype(jnp.int32))
        valid = (ws > 0) & (ws <= W) & (hs > 0) & (hs <= H)
        assert valid.any()   # the fallback box is covered by the port's own test
        f = int(np.argmax(valid))
        u_i = float(jax.random.uniform(k_i, (attempts,))[f])
        u_j = float(jax.random.uniform(k_j, (attempts,))[f])
        i_sel = int(np.floor(np.float32(u_i) * np.float32(H - hs[f] + 1)))
        j_sel = int(np.floor(np.float32(u_j) * np.float32(W - ws[f] + 1)))
        kb, kc, ks_, kh = jax.random.split(ks[1], 4)
        rows.append(dict(
            box=[i_sel, j_sel, int(hs[f]), int(ws[f])],
            fb=jax.random.uniform(kb, (), minval=0.6, maxval=1.4),
            fc=jax.random.uniform(kc, (), minval=0.6, maxval=1.4),
            fs=jax.random.uniform(ks_, (), minval=0.6, maxval=1.4),
            fh=jax.random.uniform(kh, (), minval=-0.1, maxval=0.1),
            jitter=jax.random.uniform(ks[2]) < 0.8,
            gray=jax.random.uniform(ks[3]) < 0.2,
            sigma=jax.random.uniform(ks[4], (), minval=0.1, maxval=2.0),
            blur=jax.random.uniform(ks[5]) < 0.5,
            flip=jax.random.uniform(ks[6]) < flip_p))
    cols = {k: torch.tensor(np.array([np.asarray(r[k]) for r in rows]))
            for k in rows[0]}
    return ttd.SSLParams(perm_ids=torch.tensor(np.asarray(perm_ids), dtype=torch.long),
                         **cols)


def test_ssl_chain_matches_jax_on_fed_params(tiny_cfg):
    """Three keys x 8 clip-views: every flag takes both values."""
    fn = jax.jit(jtd.make_batch_augment_fn(tiny_cfg, "ssl"))
    canvas = tuple(int(s) for s in tiny_cfg.INPUT.SCALE_SIZE)
    out_hw = tuple(int(s) for s in tiny_cfg.INPUT.BASE_SIZE)
    seen = {k: set() for k in ("jitter", "gray", "blur", "flip")}
    for seed in range(3):
        clips = np.random.default_rng(seed).integers(
            0, 256, (B, V, T, *canvas, 3), dtype=np.uint8)
        key = jax.random.key(seed)
        ref = np.asarray(fn(key, jnp.asarray(clips)))
        p = _jax_draws(key, B * V, canvas, flip_p=0.5)
        for k in seen:
            seen[k].update(getattr(p, k).tolist())
        out = ttd.apply_ssl_augment(torch.from_numpy(clips), p, out_hw,
                                    tiny_cfg.INPUT.MEAN, tiny_cfg.INPUT.STD)
        assert out.shape == ref.shape == (B, V, T, *out_hw, 3)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert all(v == {False, True} for v in seen.values()), seen


@pytest.mark.parametrize("perm", [(0, 1, 2, 3), (3, 2, 1, 0), (1, 3, 0, 2),
                                  (2, 0, 3, 1)])
def test_jitter_chain_matches_jax(perm):
    g = np.random.default_rng(sum(perm) * 10 + perm[0])
    clip = g.uniform(0, 255, (T, 3, 12, 12)).astype(np.float32)
    fb, fc, fs, fh = 1.3, 0.7, 1.25, -0.08
    ref = jtd._jitter_chain_cf(perm, jnp.asarray(clip), fb, fc, fs, fh)
    f = [torch.tensor([v]).reshape(1, 1, 1, 1, 1) for v in (fb, fc, fs, fh)]
    out = ttd._jitter_chain(perm, torch.from_numpy(clip)[None], *f)[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("sigma", [0.1, 0.9, 2.0])
def test_blur_matrix_matches_jax(sigma):
    ref = jtd._blur_matrix(20, jnp.float32(sigma))
    out = ttd.blur_matrix(20, torch.tensor([sigma]))[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("box", [(0, 0, 20, 20), (3, 5, 9, 14), (11, 0, 9, 4),
                                 (0, 17, 20, 3)])
def test_crop_resize_matches_scale_and_translate(box):
    """The port's per-axis linear weights against
    ``jax.image.scale_and_translate(method='linear', antialias=False)``
    on crop windows, edges included."""
    top, left, h, w = box
    img = np.random.default_rng(top + left).uniform(0, 255, (1, 3, 20, 24)).astype(np.float32)
    sy, sx = 16 / h, 16 / w
    ref = jax.image.scale_and_translate(
        jnp.asarray(img), (1, 3, 16, 16), (2, 3),
        jnp.asarray([sy, sx], jnp.float32),
        jnp.asarray([-top * sy, -left * sx], jnp.float32),
        method="linear", antialias=False)
    wy = ttd.resize_weights(20, 16, torch.tensor([top]), torch.tensor([h]))[0]
    wx = ttd.resize_weights(24, 16, torch.tensor([left]), torch.tensor([w]))[0]
    out = torch.einsum("yh,nchw,xw->ncyx", wy, torch.from_numpy(img), wx)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-3)


def test_port_draws_and_fused_fn(tiny_cfg):
    """The port's own draw: boxes inside the canvas (the centre fallback
    when no attempt fits), one order per group, and a fused augment that is
    a function of the generator's seed."""
    g = torch.Generator().manual_seed(0)
    p = ttd.draw_ssl_params(64, (20, 30), g, "cpu")
    top, left, h, w = p.box.unbind(1)
    assert bool(((top >= 0) & (left >= 0) & (h > 0) & (w > 0)
                 & (top + h <= 20) & (left + w <= 30)).all())
    assert p.perm_ids.shape == (8,) and int(p.perm_ids.max()) < 24
    fallback = ttd.draw_ssl_params(4, (20, 30), g, "cpu", rrc_scale=(2.0, 3.0))
    assert fallback.box.tolist() == [[0, 1, 20, 27]] * 4   # ratio clamp 4/3

    fn = ttd.make_batch_augment_fn(tiny_cfg, "ssl")
    clips = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (B, V, T, 20, 20, 3), dtype=np.uint8))
    a = fn(torch.Generator().manual_seed(1), clips)
    b = fn(torch.Generator().manual_seed(1), clips)
    c = fn(torch.Generator().manual_seed(2), clips)
    assert a.shape == (B, V, T, 16, 16, 3) and a.dtype == torch.float32
    assert torch.isfinite(a).all() and torch.equal(a, b) and not torch.equal(a, c)
