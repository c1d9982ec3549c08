"""The reference's names and the registry of the port's 2D backbones.

* For every depth: the port's backbone names are JAX's
  ``reference_*_shape_manifest``, shapes included, both ways, and a
  reference-named state_dict with seeded values through JAX's converter
  and the port's weight bridge equals it through the port's name map
  (BN-Inception's and Inception-v3's conv biases folded into the running
  means), value for value; construction only.
* Every BN module is ``layers.BatchNorm`` (flax momentum 0.9; eps 1e-5 for
  the ResNets, 1e-3 for the Inception nets), and partial BN leaves the
  first conv's alone live.
* The registry builds all seven names for moco, bank, simsiam and
  ``create_video_model``, with JAX's feature dims, no graph block under
  ``MODEL.AUG_FLAG True``, and ``TPU.SEPCONV_FUSED`` raising
  ``ValueError``; the bare schema (``resnet101``, 2D) builds.
"""

import numpy as np
import pytest
import torch

from _torch_resnet_util import jax_converted, make_cfg, reference_state_dict
from video_graph_ssl_tpu.config import cfg as jax_cfg
from video_graph_ssl_tpu.utils import torch_interop
from video_graph_ssl_tpu_torch.models import build, layers
from video_graph_ssl_tpu_torch.models.build import BACKBONES_2D, create_visual_model
from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug
from video_graph_ssl_tpu_torch.utils.torch_names import (layout_of, port_backbone_names,
                                                          reference_backbone_names)

torch.set_num_threads(1)
FEATURE_DIMS = {"resnet18": 512, "resnet34": 512, "resnet50": 2048, "resnet101": 2048,
                "resnet152": 2048, "bninception": 1024, "inception_v3": 2048}
DEPTHS = {"resnet18": 18, "resnet34": 34, "resnet50": 50, "resnet101": 101, "resnet152": 152}


def cfg2d(name, dtype="float32", **kw):
    return make_cfg(name, "2D", dtype, **kw)


# --------------------------------------------------------------------------- #
# the reference's names
# --------------------------------------------------------------------------- #
def _manifest_and_converter(name):
    if name in DEPTHS:
        return (torch_interop.reference_resnet_shape_manifest(DEPTHS[name], 2),
                lambda sd: torch_interop.convert_torch_resnet(sd, 2))
    if name == "bninception":
        return (torch_interop.reference_bninception_shape_manifest(),
                torch_interop.convert_torch_bninception)
    return (torch_interop.reference_inception_v3_shape_manifest(),
            torch_interop.convert_torch_inception_v3)


@pytest.mark.parametrize("name", sorted(FEATURE_DIMS))
def test_name_maps_are_the_manifests_and_converters(name):
    own = BACKBONES_2D[name][0]().state_dict()
    manifest, convert = _manifest_and_converter(name)
    layout = "resnet" if name in DEPTHS else name
    ref = reference_backbone_names(own, layout)
    assert sorted(ref) == sorted(manifest)
    for k, shape in manifest.items():
        assert tuple(ref[k].shape) == tuple(shape), k
    back = port_backbone_names(ref)
    assert sorted(back) == sorted(own)
    assert all(torch.equal(back[k], v) for k, v in own.items())
    # seeded reference values, with a classifier and BN counters: JAX's
    # converter + the port's weight bridge == the port's name map
    sd = reference_state_dict(manifest)
    sd["fc.weight"], sd["fc.bias"] = np.zeros((10, FEATURE_DIMS[name]), np.float32), np.zeros(10)
    assert layout_of(sd) == layout
    ours = port_backbone_names({**sd, "bn1.num_batches_tracked": np.int64(3)}
                               if name in DEPTHS else sd)
    theirs = jax_converted(convert, sd)
    assert sorted(ours) == sorted(theirs) == sorted(own)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", sorted(FEATURE_DIMS))
def test_every_bn_is_the_port_batchnorm(name):
    model = BACKBONES_2D[name][0](partial_bn=True)
    bns = [m for m in model.modules() if "Norm" in type(m).__name__]
    assert bns and all(type(m) is layers.BatchNorm for m in bns)
    eps = 1e-5 if name in DEPTHS else 1e-3
    assert all(m.momentum == 0.9 and m.eps == eps for m in bns)
    # partial BN: the first conv's BN alone stays live
    live = [n for n, m in model.named_modules() if isinstance(m, layers.BatchNorm)
            and not m.frozen]
    assert live == [{"bninception": "conv1.bn",
                     "inception_v3": "Conv2d_1a_3x3.bn"}.get(name, "bn1")]


@pytest.mark.parametrize("name", sorted(FEATURE_DIMS))
def test_registry_builds_every_2d_name(name, monkeypatch):
    # construction is what is tested: the parameter init is skipped
    monkeypatch.setattr(build, "init_params_", lambda *a, **k: None)
    for mem_type in ("moco", "bank", "simsiam"):
        c = cfg2d(name, mem_type=mem_type)
        c.MODEL.AUG_FLAG = True            # a 2D backbone builds no graph block
        c.GRAPH.AUG_POINTS = ()
        model, dim = build.create_visual_model(c)
        assert dim == FEATURE_DIMS[name]
        enc = model.model.encoder
        assert enc.backbone_type == "2D" and enc.base_model.feature_dim == dim
        assert not any(isinstance(m, TemporalGraphAug) for m in model.modules())
    c.DATASET.NUM_CLASS = 8
    video, vdim = build.create_video_model(c)
    assert vdim == FEATURE_DIMS[name] and video.new_fc.in_features == vdim
    c.TPU.SEPCONV_FUSED = True
    with pytest.raises(ValueError, match="SEPCONV_FUSED"):
        build.create_visual_model(c)


def test_bare_schema_builds_resnet101_2d():
    c = jax_cfg.clone()
    assert (c.MODEL.BACKBONE, c.MODEL.BACKBONE_TYPE) == ("resnet101", "2D")
    model, dim = create_visual_model(c)
    assert dim == 2048 and model.model.encoder.backbone_type == "2D"
    c.MODEL.BACKBONE_TYPE = "3D"
    with pytest.raises(NotImplementedError, match="MODEL.BACKBONE_TYPE 2D"):
        create_visual_model(c)
