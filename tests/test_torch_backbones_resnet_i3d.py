"""The port's factorized 3D ResNets (``resnet_i3d_*``: each 3x3x3 conv a
(1,3,3) spatial + (3,1,1) temporal pair) against the JAX package on the
CPU, with graph blocks on the inputs of stages 2, 3 and 4 (B = 2, T = 16,
64x64; why not 32x32: ``test_torch_backbones_resnet3d.py``), at the
shallowest depth of each block type: ``resnet_i3d_18`` (factorized basic)
and ``resnet_i3d_50`` (factorized bottleneck).

* Eval features and projections (graph sampler none), JAX variables carried
  through ``utils/jax_weights.py`` (strict), within 1e-5 in fp32.
* Train mode in float64 (JAX's fp32 BN pin lifted, ``_torch_resnet_util``),
  the relaxed-Bernoulli sampler on with JAX's draws injected: the output,
  every parameter gradient (the stem, the blocks and the three graph
  blocks among them) and every BN statistic within 1e-4.
"""

import pytest

from _torch_resnet_util import eval_parity, make_cfg, rel_l2, train_parity

SHAPE = (2, 16, 64, 64, 3)
AUG = (2, 3, 4)
FAMILIES = {"resnet_i3d_18": 512, "resnet_i3d_50": 2048}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_eval_features_match_jax(name):
    feat, feat_ref, proj, proj_ref, params = eval_parity(make_cfg(name, aug=AUG), SHAPE)
    assert sorted(k for k in params["model"]["encoder"]["base_model"]
                  if k.startswith("graph_aug")) == [f"graph_aug_{s}" for s in AUG]
    assert feat.shape == (2, FAMILIES[name])
    assert rel_l2(feat, feat_ref) < 1e-5
    assert rel_l2(proj, proj_ref) < 1e-5


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_train_forward_grads_and_bn_stats_match_jax(name, monkeypatch):
    c = make_cfg(name, dtype="float64", aug=AUG, sampler="relaxed_bernoulli")
    model = train_parity(c, SHAPE, monkeypatch)
    named = dict(model.named_parameters())
    enc = "model.encoder.base_model."
    for n in ("conv1.weight", "layer2.0.g_q.0.weight",
              "layer3.0.gcns.0.conv.weight", "layer4.1.0.downsample.0.weight"):
        assert enc + n in named, n
