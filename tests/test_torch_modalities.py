"""The port's non-RGB input modalities against the JAX package on the CPU
(the counterparts of ``tests/test_modalities.py``), fp32.

* ``rgb_diff``, ``expand_stats``, normalisation over stacked channels and
  the Flow flip (x-flow channels inverted in pixel space) against JAX's.
* The SSL chain on 6- and 10-channel clips (RGB stacks fold into 3-channel
  frames with one set of factors per clip; Flow takes no colour op) and the
  ``train`` chain on RGB-stacked and Flow clips, with JAX's draws injected,
  against ``make_batch_augment_fn``.
* The Flow and RGBDiff encoders (tiny3d and S3D, eval mode) from the same
  weights, carried through the weight bridge (stems of any input-channel
  count), and ``NEW_LENGTH`` -1 resolving by modality.
* ``inflate_first_conv`` against JAX's, its errors, and an inflated RGB
  state loading strictly into the Flow model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import np_tree, rel_l2
from _torch_resnet_util import setup
from test_torch_augment import _jax_draws
from test_torch_downstream_transforms import MEAN, STD, _jax_train_draws, rel_max
from video_graph_ssl_tpu.data import transforms_device as jtd
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu.models.wrappers import rgb_diff as jax_rgb_diff
from video_graph_ssl_tpu.utils.inflate import inflate_first_conv as jax_inflate
from video_graph_ssl_tpu_torch.data import transforms_device as ttd
from video_graph_ssl_tpu_torch.models import build as port_build
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.models.wrappers import rgb_diff
from video_graph_ssl_tpu_torch.utils.inflate import find_first_conv, inflate_first_conv
from video_graph_ssl_tpu_torch.utils.jax_weights import load_pretrain_weights, pretrain_state_dict

torch.set_num_threads(1)
TOL = 1e-5


def _clips(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def test_rgb_diff_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 4, 9)).astype(np.float32)
    ours = rgb_diff(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_rgb_diff(jnp.asarray(x))))
    assert ours.shape == (2, 3, 4, 4, 6)


@pytest.mark.parametrize("vals,n", [((0.5, 0.4, 0.3), 3), ((0.5, 0.4, 0.3), 6),
                                    ((0.3, 0.6, 0.6), 10), ((0.3, 0.6, 0.6), 2)])
def test_expand_stats_matches_jax(vals, n):
    assert ttd.expand_stats(vals, n) == jtd.expand_stats(vals, n)


@pytest.mark.parametrize("c", [6, 10])
def test_normalize_stacked_channels_matches_jax(c):
    x = _clips((2, 3, 5, 5, c), seed=c).astype(np.float32)
    ours = ttd._normalize(torch.from_numpy(x), MEAN, STD).numpy()
    ref = np.stack([np.asarray(jtd.normalize(jnp.asarray(v), MEAN, STD)) for v in x])
    assert rel_max(ours, ref) < TOL


@pytest.mark.parametrize("c", [2, 10])
def test_flow_flip_matches_jax(c):
    x = _clips((3, 2, 4, 5, c), seed=1).astype(np.float32)
    ours = ttd.flow_flip(torch.from_numpy(x)).numpy()
    ref = np.stack([np.asarray(jtd.random_horizontal_flip(jax.random.key(0), jnp.asarray(v),
                                                          p=1.0, is_flow=True)) for v in x])
    np.testing.assert_array_equal(ours, ref)
    # x-flow channels inverted, y-flow channels only mirrored
    np.testing.assert_array_equal(ours[..., 1::2], x[:, :, :, ::-1, 1::2])


@pytest.mark.parametrize("c", [6, 10])
def test_ssl_chain_on_stacked_channels_matches_jax(tiny_cfg, c):
    b, v, t = 2, 2, 2
    fn = jax.jit(jtd.make_batch_augment_fn(tiny_cfg, "ssl"))
    canvas = tuple(int(s) for s in tiny_cfg.INPUT.SCALE_SIZE)
    out_hw = tuple(int(s) for s in tiny_cfg.INPUT.BASE_SIZE)
    clips = _clips((b, v, t, *canvas, c), seed=c)
    key = jax.random.key(c)
    ref = np.asarray(fn(key, jnp.asarray(clips)))
    p = _jax_draws(key, b * v, canvas, flip_p=0.5)
    ours = ttd.apply_ssl_augment(torch.from_numpy(clips), p, out_hw, tiny_cfg.INPUT.MEAN,
                                 tiny_cfg.INPUT.STD)
    assert ours.shape == ref.shape == (b, v, t, *out_hw, c)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)
    if c == 6:   # the colour ops ran: a jittered clip-view differs from its plain chain
        assert bool(p.jitter.any())


@pytest.mark.parametrize("modality,c", [("RGB", 6), ("Flow", 10)])
def test_train_chain_on_stacked_channels_matches_jax(tiny_cfg, modality, c):
    cfg = tiny_cfg.clone()
    cfg.INPUT.MODALITY = modality
    cfg.INPUT.BASE_SIZE = [32, 32]
    x = _clips((12, 2, 40, 40, c), seed=5)
    key = jax.random.key(3)
    ref = np.asarray(jtd.make_batch_augment_fn(cfg, "train")(key, jnp.asarray(x)))
    p = _jax_train_draws(key, x.shape[0], len(ttd.msc_crop_pairs(40, 40, (32, 32))))
    assert p.flip.any() and not p.flip.all()
    ours = ttd.apply_train_augment(torch.from_numpy(x), p, (32, 32), MEAN, STD,
                                   is_flow=modality == "Flow")
    assert rel_max(ours, ref) < TOL
    gen = torch.Generator().manual_seed(0)   # the port's own draws run too
    out = ttd.make_batch_augment_fn(cfg, "train")(gen, torch.from_numpy(x))
    assert out.shape == (12, 2, 32, 32, c) and torch.isfinite(out).all()


def _cfg(tiny_cfg, backbone, modality, new_length, size=16, length=4):
    c = tiny_cfg.clone()
    c.MODEL.BACKBONE = backbone
    c.MODEL.AUG_FLAG = backbone == "tiny3d"
    c.GRAPH.SAMPLER = "none"
    c.INPUT.MODALITY = modality
    c.INPUT.NEW_LENGTH = new_length
    c.INPUT.VIDEO_LENGTH = length
    c.INPUT.BASE_SIZE = [size, size]
    c.TPU.PACK_POINTWISE = False
    return c


@pytest.mark.parametrize("backbone,modality,nl,c_in,size,length", [
    ("tiny3d", "Flow", 2, 4, 16, 4), ("tiny3d", "RGBDiff", 2, 9, 16, 4),
    ("tiny3d", "Flow", -1, 10, 16, 4), ("S3D", "Flow", 5, 10, 32, 8),
    ("S3D", "RGBDiff", 5, 18, 32, 8)])
def test_encoder_forward_matches_jax(tiny_cfg, backbone, modality, nl, c_in, size, length):
    c = _cfg(tiny_cfg, backbone, modality, nl, size, length)
    x, _, params, stats = setup(c, (2, length, size, size, c_in))
    jmodel, _ = jax_create(c)
    ref = np.asarray(jax.jit(lambda v, xx: jmodel.apply(v, xx, method=jmodel.encode))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    params, stats = np_tree(params), np_tree(stats)
    model, _ = create_visual_model(c)
    assert port_build.input_channels(c) == (c_in // 3 * 3 - 3 if modality == "RGBDiff"
                                            else c_in)
    load_pretrain_weights(model, params, stats)   # strict
    model.eval()
    with torch.no_grad():
        ours = model.encode(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    assert rel_l2(ours, ref) < TOL


def test_inflate_first_conv_matches_jax(tiny_cfg):
    """S3D's stem (the pretrain model's names), RGB -> Flow NEW_LENGTH 5."""
    c = _cfg(tiny_cfg, "S3D", "RGB", 1, 32, 8)
    _, _, params, stats = setup(c, (2, 8, 32, 32, 3))
    stats = np_tree(stats)
    rgb = pretrain_state_dict(np_tree(params), stats)
    ref = pretrain_state_dict(np_tree(jax_inflate(params, 10)), stats)
    ours = inflate_first_conv({k: torch.from_numpy(v.copy()) for k, v in rgb.items()}, 10)
    name, w = find_first_conv(ours, 10)
    assert name == "model.encoder.base_model.base.0.conv_s.weight"
    assert tuple(w.shape) == (64, 10, 1, 7, 7)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k].numpy(), v, rtol=1e-6, atol=1e-7, err_msg=k)
    # the inflated RGB state loads strictly into the Flow model
    flow, _ = create_visual_model(_cfg(tiny_cfg, "S3D", "Flow", 5, 32, 8))
    flow.load_state_dict(ours, strict=True)
    with pytest.raises(ValueError, match="no conv kernel with 4 input channels"):
        find_first_conv(ours, 4)
    twice = dict(ours, **{"extra.weight": torch.zeros(8, 10, 1, 1, 1)})
    with pytest.raises(ValueError, match="ambiguous stem conv"):
        inflate_first_conv(twice, 2, old_in_channels=10)


def test_new_length_resolves_by_modality(tiny_cfg):
    for modality, nl, want in (("RGB", -1, 3), ("Flow", -1, 10), ("RGBDiff", -1, 15),
                               ("RGB", 2, 6), ("Flow", 1, 2)):
        c = _cfg(tiny_cfg, "tiny3d", modality, nl)
        assert port_build.input_channels(c) == want
        model, _ = create_visual_model(c)
        assert model.model.encoder.base_model.stage0.conv.weight.shape[1] == want
    with pytest.raises(ValueError, match="MODALITY"):
        port_build.input_channels(_cfg(tiny_cfg, "tiny3d", "Depth", 1))
