"""The reference's names and the registry of the port's 3D ResNets (R3D,
``resnet_i3d``, R(2+1)D).

* For every depth: the port's backbone names (graph blocks off) are JAX's
  ``reference_resnet_shape_manifest(depth, 3)``,
  ``reference_resnet_i3d_shape_manifest`` or
  ``reference_resnet2p1d_shape_manifest``, shapes included, both ways (the
  map is the identity), and a reference-named state_dict with seeded values
  through JAX's converter (``convert_torch_resnet``, ``_resnet_i3d``,
  ``_resnet2p1d``) and the port's weight bridge equals it through the
  port's name map, value for value; construction only.
* Every BN module is ``layers.BatchNorm`` with flax momentum 0.9 and eps
  1e-5, the graph blocks' included; partial BN leaves the stem's BNs and
  the graph blocks' live.
* The registry builds every 3D ResNet name for moco, bank, simsiam and
  ``create_video_model`` with JAX's feature dim and aug points (2, 3, 4),
  graph blocks on those stages' inputs under ``MODEL.AUG_FLAG``;
  ``TPU.SEPCONV_FUSED`` raises ``ValueError``.  ``i3d_res50_nonlocal``
  builds for every regime too, with JAX's feature dim and aug points and
  its non-local blocks on layer2.1 and layer2.3, and the port's 3D registry
  holds every name of JAX's.  (The parameter init is skipped here:
  construction is what is tested, and the init of 129M parameters takes
  9 s a model.)
* ``jax_weights.backbone_of`` tells JAX's ``I3DResNetNonLocal`` tree from
  ``resnet3d_50``'s (the same field names) both ways, and
  ``kernel_times.step_calls`` counts its MoCo step: K1 6, K2 9, K3 0, K4 2.
"""

import numpy as np
import pytest
import torch

from _torch_resnet_util import jax_converted, make_cfg, reference_state_dict
from video_graph_ssl_tpu.models.build import BACKBONES_3D as JAX_BACKBONES_3D
from video_graph_ssl_tpu.utils import torch_interop as ti
from video_graph_ssl_tpu_torch.models import build, layers
from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug
from video_graph_ssl_tpu_torch.utils.torch_names import (layout_of, port_backbone_names,
                                                          reference_backbone_names)

torch.set_num_threads(1)
DEPTHS = (10, 18, 34, 50, 101, 152, 200)
NAMES = ([f"resnet3d_{d}" for d in DEPTHS] + [f"resnet_i3d_{d}" for d in (18, 50, 101)]
         + [f"resnet2p1d_{d}" for d in DEPTHS])


def _manifest_and_converter(name):
    depth = int(name.rsplit("_", 1)[1])
    if name.startswith("resnet3d_"):
        return (ti.reference_resnet_shape_manifest(depth, 3),
                lambda sd: ti.convert_torch_resnet(sd, 3))
    if name.startswith("resnet_i3d_"):
        return ti.reference_resnet_i3d_shape_manifest(depth), ti.convert_torch_resnet_i3d
    return ti.reference_resnet2p1d_shape_manifest(depth), ti.convert_torch_resnet2p1d


@pytest.mark.parametrize("name", NAMES)
def test_name_maps_are_the_manifests_and_converters(name):
    own = build.BACKBONES_3D[name][0]().state_dict()
    manifest, convert = _manifest_and_converter(name)
    ref = reference_backbone_names(own, "resnet")
    assert sorted(ref) == sorted(manifest)
    for k, shape in manifest.items():
        assert tuple(ref[k].shape) == tuple(shape), k
    back = port_backbone_names(ref)
    assert sorted(back) == sorted(own) and all(back[k] is v for k, v in own.items())
    # seeded reference values, with a classifier and BN counters: JAX's
    # converter + the port's weight bridge == the port's name map
    sd = reference_state_dict(manifest)
    assert layout_of(sd) == "resnet"
    ours = port_backbone_names({**sd, "fc.weight": np.zeros((10, 4)), "fc.bias": np.zeros(10),
                                "bn1.num_batches_tracked": np.int64(3)})
    theirs = jax_converted(convert, sd)
    assert sorted(ours) == sorted(theirs) == sorted(own)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("name", ["resnet3d_18", "resnet3d_50", "resnet_i3d_18",
                                  "resnet_i3d_50", "resnet2p1d_18", "resnet2p1d_50"])
def test_every_bn_is_the_port_batchnorm(name):
    model = build.BACKBONES_3D[name][0](aug_points=(2, 3, 4), graph_cfg={"bn_layer": True},
                                        partial_bn=True)
    bns = [m for m in model.modules() if "Norm" in type(m).__name__]
    assert bns and all(type(m) is layers.BatchNorm for m in bns)
    assert all(m.momentum == 0.9 and m.eps == 1e-5 for m in bns)
    live = sorted(n for n, m in model.named_modules() if isinstance(m, layers.BatchNorm)
                  and not m.frozen)
    stem = ["bn1_s", "bn1_t"] if name.startswith("resnet2p1d") else ["bn1"]
    graph = [f"layer{s}.0.{e}.0.1" for s in (2, 3, 4) for e in ("g_k", "g_q")]
    assert live == sorted(stem + graph)


@pytest.mark.parametrize("name", NAMES)
def test_registry_builds_every_3d_resnet(name, monkeypatch):
    monkeypatch.setattr(build, "init_params_", lambda *a, **k: None)
    _, jax_dim, jax_aug = JAX_BACKBONES_3D[name]
    for mem_type in ("moco", "bank", "simsiam"):
        c = make_cfg(name, aug=(), mem_type=mem_type)
        c.MODEL.AUG_FLAG = True
        model, dim = build.create_visual_model(c)
        base = model.model.encoder.base_model
        assert dim == jax_dim == base.feature_dim
        assert base.aug_points == tuple(jax_aug) == (2, 3, 4)
        graphs = [n for n, m in base.named_modules() if isinstance(m, TemporalGraphAug)]
        assert graphs == ["layer2.0", "layer3.0", "layer4.0"]
    c.DATASET.NUM_CLASS = 8
    video, vdim = build.create_video_model(c)
    assert vdim == jax_dim and video.new_fc.in_features == vdim
    assert video.base_model.aug_points == (2, 3, 4)
    c.TPU.SEPCONV_FUSED = True
    with pytest.raises(ValueError, match="SEPCONV_FUSED"):
        build.create_visual_model(c)


def test_nonlocal_i3d_builds_for_every_regime(monkeypatch):
    monkeypatch.setattr(build, "init_params_", lambda *a, **k: None)
    name = "i3d_res50_nonlocal"
    _, jax_dim, jax_aug = JAX_BACKBONES_3D[name]
    nonlocal_blocks = ["layer2.1.1.non_local", "layer2.1.3.non_local"]
    for mem_type, cross in (("moco", "visual"), ("bank", "visual"), ("simsiam", "visual"),
                            ("moco", "cross")):
        c = make_cfg(name, aug=(), mem_type=mem_type)
        c.MODEL.AUG_FLAG = True
        c.CROSS.MODALITY = cross
        model, dim = build.create_visual_model(c)
        stacks = ([model.model_1, model.model_2] if cross == "cross" else [model])
        for stack in stacks:
            base = stack.model.encoder.base_model
            assert dim == jax_dim == base.feature_dim == 2048
            assert base.aug_points == tuple(jax_aug) == (2, 3, 4)
            graphs = [n for n, m in base.named_modules() if isinstance(m, TemporalGraphAug)]
            assert graphs == ["layer2.0", "layer3.0", "layer4.0"]
            nls = [n for n, m in base.named_modules() if type(m).__name__ == "NonLocalBlock3D"]
            assert nls == nonlocal_blocks
    c = make_cfg(name)
    c.DATASET.NUM_CLASS = 8
    video, vdim = build.create_video_model(c)
    assert vdim == jax_dim and video.new_fc.in_features == vdim
    assert [n for n, m in video.base_model.named_modules()
            if type(m).__name__ == "NonLocalBlock3D"] == ["layer2.1.non_local",
                                                          "layer2.3.non_local"]
    c.TPU.SEPCONV_FUSED = True
    with pytest.raises(ValueError, match="SEPCONV_FUSED"):
        build.create_visual_model(c)
    # every JAX 3D name builds in the port
    assert set(build.BACKBONES_3D) == set(JAX_BACKBONES_3D)
    assert not hasattr(build, "NOT_PORTED_3D")


def test_backbone_of_tells_nonlocal_i3d_from_resnet3d_50():
    import jax
    import jax.numpy as jnp

    from video_graph_ssl_tpu.models import i3dnon as jax_i3dnon
    from video_graph_ssl_tpu.models import resnet3d as jax_resnet3d
    from video_graph_ssl_tpu_torch.kernel_times import step_calls
    from video_graph_ssl_tpu_torch.utils.jax_weights import backbone_of

    x = jax.ShapeDtypeStruct((1, 16, 32, 32, 3), jnp.float32)

    def tree(model):
        return jax.eval_shape(lambda v: model.init({"params": jax.random.key(0)}, v),
                              x)["params"]

    nl = tree(jax_i3dnon.I3DResNetNonLocal(layers=(3, 4, 6, 3)))
    r50 = tree(jax_resnet3d.ResNet3D(block="bottleneck", layers=(3, 4, 6, 3)))
    assert set(nl) == set(r50)          # the same field names at the top
    assert backbone_of(nl) == "i3d_res50_nonlocal"
    assert backbone_of(r50) == "resnet3d_50"
    # either mark alone: the non-local child, or the (5, 7, 7) stem
    no_nl = {**nl, "layer2_1": {k: v for k, v in nl["layer2_1"].items() if k != "nonlocal"}}
    assert backbone_of(no_nl) == "i3d_res50_nonlocal"
    assert backbone_of({**r50, "layer2_1": nl["layer2_1"]}) == "i3d_res50_nonlocal"
    assert step_calls("moco", backbone="i3d_res50_nonlocal") == {
        "graph_adjacency": 6, "gcn_propagate": 9, "maxpool_bwd_s1": 0,
        "maxpool_bwd_strided": 2, "sepconv_bwd": 0}
    assert step_calls("finetune", partial_bn=True, backbone="i3d_res50_nonlocal") == {
        "graph_adjacency": 3, "gcn_propagate": 6, "maxpool_bwd_s1": 0,
        "maxpool_bwd_strided": 2, "sepconv_bwd": 0}
