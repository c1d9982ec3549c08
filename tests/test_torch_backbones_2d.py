"""The port's 2D backbones (``MODEL.BACKBONE_TYPE 2D``: ResNet-18 .. 152,
BN-Inception, Inception-v3) and the 2D branch of ``VisualEncoder`` against
the JAX package on the CPU (the steps: ``test_torch_backbones_2d_steps.py``;
names and registry: ``test_torch_backbones_2d_registry.py``).

* Eval features and projections through the whole ``GraphWrapper``
  (frames folded into the batch, the 2D backbone, the average over T),
  JAX variables carried through ``utils/jax_weights.py`` (strict), within
  1e-5 in fp32: ``resnet18`` (basic blocks), ``resnet50`` (bottlenecks),
  ``bninception`` and ``inception_v3`` at B = 2, T = 2-4, 64x64 (75x75,
  Inception-v3's least, for it).
* Train mode in float64 (JAX's fp32 BN pin lifted, ``_torch_resnet_util``):
  the output, every parameter gradient and every BN statistic within 1e-4.
  Train-mode BN here normalises over the B x T frames of both clips.
"""

import pytest
import torch

from _torch_resnet_util import eval_parity, make_cfg, rel_l2, train_parity
from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug

torch.set_num_threads(1)
# (B, T, H, W, C) per backbone
SHAPES = {"resnet18": (2, 3, 64, 64, 3), "resnet50": (2, 2, 64, 64, 3),
          "bninception": (2, 2, 64, 64, 3), "inception_v3": (2, 2, 75, 75, 3)}
FEATURE_DIMS = {"resnet18": 512, "resnet34": 512, "resnet50": 2048, "resnet101": 2048,
                "resnet152": 2048, "bninception": 1024, "inception_v3": 2048}


def cfg2d(name, dtype="float32", **kw):
    return make_cfg(name, "2D", dtype, **kw)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_eval_features_match_jax(name):
    feat, feat_ref, proj, proj_ref, params = eval_parity(cfg2d(name), SHAPES[name])
    assert feat.shape == (SHAPES[name][0], FEATURE_DIMS[name]) and proj.shape == (2, 128)
    assert rel_l2(feat, feat_ref) < 1e-5
    assert rel_l2(proj, proj_ref) < 1e-5


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_train_forward_grads_and_bn_stats_match_jax(name, monkeypatch):
    model = train_parity(cfg2d(name, "float64"), SHAPES[name], monkeypatch)
    assert not any(isinstance(m, TemporalGraphAug) for m in model.modules())
