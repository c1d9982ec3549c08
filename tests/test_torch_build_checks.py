"""The port's builder refuses what the JAX builder refuses for the TPU
layouts ``TPU.REMAT`` / ``TPU.REMAT_POLICY`` and ``TPU.STEM_S2D``.

The same configs go through both packages' builders
(``create_visual_model`` and ``create_video_model``): where JAX raises a
``ValueError`` (``video_graph_ssl_tpu/models/build.py:_resolve_remat`` and
``encoder_cfg_from``), the port raises the same class with the same
message, in JAX's order; where JAX builds, the port builds too (a valid
``TPU.REMAT True`` with the backbone's ``remat`` set as JAX's encoder sets
it); a valid ``TPU.STEM_S2D`` other than off builds the space-to-depth
stem in both, and the port's encoder features match JAX's on the same
weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import fill_variables, rel_l2
from video_graph_ssl_tpu.config import cfg as jax_cfg
from video_graph_ssl_tpu.models import create_video_model as jax_video
from video_graph_ssl_tpu.models import create_visual_model as jax_visual
from video_graph_ssl_tpu_torch.models.build import (create_video_model, create_visual_model,
                                                    stem_s2d_mode)
from video_graph_ssl_tpu_torch.models.layers import SepConvS2D
from video_graph_ssl_tpu_torch.utils.jax_weights import pretrain_state_dict

torch.set_num_threads(1)
BUILDERS = [(jax_visual, create_visual_model), (jax_video, create_video_model)]


def _cfg(backbone="S3D", **tpu):
    c = jax_cfg.clone()
    c.MODEL.BACKBONE = backbone
    c.MODEL.BACKBONE_TYPE = "3D"
    c.MODEL.AUG_FLAG = False
    c.CONTRAST.MEM_TYPE = "moco"
    c.CROSS.FEAT_DIM = 32
    c.TPU.COMPUTE_DTYPE = "float32"
    for k, v in tpu.items():
        setattr(c.TPU, k, v)
    return c


def _jax_error(build, c):
    try:
        build(c)
    except ValueError as e:
        return e
    return None


# configs that JAX refuses with a ValueError
REFUSED = [
    ("remat policy bad", "S3D", dict(REMAT=True, REMAT_POLICY="everything")),
    ("remat policy bad, tiny3d", "tiny3d", dict(REMAT=True, REMAT_POLICY="")),
    ("conv_saved off S3D", "tiny3d", dict(REMAT=True, REMAT_POLICY="conv_saved")),
    ("conv_saved on I3D", "I3D", dict(REMAT=True, REMAT_POLICY="conv_saved")),
    ("stem_s2d bad", "S3D", dict(STEM_S2D="depth")),
    ("stem_s2d bad on S3DG", "S3DG", dict(STEM_S2D="yes")),
    ("stem_s2d full off S3D", "tiny3d", dict(STEM_S2D="full")),
    ("stem_s2d true on I3D", "I3D", dict(STEM_S2D=True)),
    ("stem_s2d spatial on a ResNet", "resnet3d_10", dict(STEM_S2D="spatial")),
    # JAX's order: the stem first, then SEPCONV_FUSED, then the remat policy
    ("stem_s2d bad before remat bad", "S3D",
     dict(STEM_S2D="depth", REMAT=True, REMAT_POLICY="x")),
    ("sepconv_fused off S3D before remat bad", "S3DG",
     dict(SEPCONV_FUSED=True, REMAT=True, REMAT_POLICY="x")),
]


@pytest.mark.parametrize("builders", BUILDERS, ids=["visual", "video"])
@pytest.mark.parametrize("name,backbone,tpu", REFUSED, ids=[r[0] for r in REFUSED])
def test_refused_like_jax(builders, name, backbone, tpu):
    jax_build, port_build = builders
    c = _cfg(backbone, **tpu)
    want = _jax_error(jax_build, c)
    assert want is not None, f"{name}: JAX builds it"
    with pytest.raises(ValueError) as got:
        port_build(c)
    assert type(got.value) is type(want) and str(got.value) == str(want)


# valid TPU.REMAT True: JAX builds (jax.checkpoint), and so does the port
# (torch.utils.checkpoint), its backbone's remat the JAX encoder's
REMAT_VALID = [("S3D", "block"), ("S3D", "conv_saved"), ("S3DG", "conv_saved"),
               ("tiny3d", "block"), ("resnet3d_10", "block")]


@pytest.mark.parametrize("backbone,policy", REMAT_VALID)
def test_remat_true_builds_in_both(backbone, policy):
    c = _cfg(backbone, REMAT=True, REMAT_POLICY=policy)
    for jax_build, port_build in BUILDERS:
        assert _jax_error(jax_build, c) is None
        jax_model, _ = jax_build(c)
        want = jax_model.encoder_cfg["remat"]
        assert want == (True if policy == "block" else policy)
        model, _ = port_build(c)
        encoder = model if hasattr(model, "new_fc") else model.model.encoder
        assert encoder.base_model.remat == want


# valid TPU.STEM_S2D values: off and its aliases build in both, and so
# does an S2D stem, whose forward matches JAX's
STEM_OFF = ["off", "false", "0", "none", "", False]
STEM_ON = [("S3D", "full"), ("S3D", "true"), ("S3D", "1"), ("S3D", True),
           ("S3D", "spatial"), ("S3DG", "full"), ("S3DG", "Spatial")]


@pytest.mark.parametrize("value", STEM_OFF, ids=[repr(v) for v in STEM_OFF])
def test_stem_s2d_off_builds_in_both(value):
    c = _cfg("tiny3d", STEM_S2D=value, REMAT=False, REMAT_POLICY="ignored when off")
    for jax_build, port_build in BUILDERS:
        assert _jax_error(jax_build, c) is None
        model, _ = port_build(c)
        assert isinstance(model, torch.nn.Module)


_JAX_FEATURES = {}


def _jax_features(c, x):
    """(variables, encoder features) of JAX's visual model for ``c``, once
    per (backbone, stem mode): "true", "1" and True are "full"."""
    key = (c.MODEL.BACKBONE, stem_s2d_mode(c, c.MODEL.BACKBONE))
    if key not in _JAX_FEATURES:
        jmodel, _ = jax_visual(c)
        shapes = jax.eval_shape(lambda v: jmodel.init({"params": jax.random.key(0)}, v), x)
        v = fill_variables(shapes, 0)
        feats = jax.jit(lambda vv, xx: jmodel.apply(vv, xx, method=jmodel.encode))(v, x)
        _JAX_FEATURES[key] = (v, np.asarray(feats))
    return _JAX_FEATURES[key]


@pytest.mark.parametrize("backbone,value", STEM_ON, ids=[f"{b}-{v!r}" for b, v in STEM_ON])
def test_stem_s2d_on_raises_by_name(backbone, value):
    """Formerly the port refused a valid S2D stem by name; now each value
    builds in both builders, and on JAX's weights (the visual model's
    encoder, carried into the downstream model's backbone) the port's
    encoder features match JAX's in eval, fp32, at 1e-5 rel-L2."""
    c = _cfg(backbone, STEM_S2D=value)
    x = np.random.default_rng(0).standard_normal((2, 8, 32, 32, 3)).astype(np.float32)
    v, want = _jax_features(c, jnp.asarray(x))
    sd = {k: torch.from_numpy(np.asarray(t)) for k, t in pretrain_state_dict(
        v["params"], v["batch_stats"], backbone).items()}
    pre = "model.encoder.base_model."
    for jax_build, port_build in BUILDERS:
        assert _jax_error(jax_build, c) is None
        model, _ = port_build(c)
        encoder = model if hasattr(model, "new_fc") else model.model.encoder
        assert isinstance(encoder.base_model.base[0], SepConvS2D)
        encoder.base_model.load_state_dict(
            {k[len(pre):]: t for k, t in sd.items() if k.startswith(pre)}, strict=True)
        model.eval()
        features = model.encode if encoder is model else encoder
        with torch.no_grad():
            got = features(torch.from_numpy(x))
        assert rel_l2(got.numpy(), want) < 1e-5
