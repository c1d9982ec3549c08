"""The port's R(2+1)D backbones (``resnet2p1d_*``) against the JAX package on
the CPU, with graph blocks on the inputs of stages 2, 3 and 4 (B = 2,
T = 16, 64x64; why not 32x32: ``test_torch_backbones_resnet3d.py``), at the
shallowest depth of each block type: ``resnet2p1d_10`` (basic) and
``resnet2p1d_50`` (bottleneck).

* Eval features and projections (graph sampler none), JAX variables carried
  through ``utils/jax_weights.py`` (strict), within 1e-5 in fp32.
* Train mode in float64 (JAX's fp32 BN pin lifted, ``_torch_resnet_util``),
  the relaxed-Bernoulli sampler on with JAX's draws injected: the output,
  every parameter gradient and every BN statistic within 1e-4 --
  ``resnet2p1d_10`` here, ``resnet2p1d_50`` in
  ``test_torch_backbones_r2plus1d_50.py``.
* The (2+1)D widths: the stem's middle width is 110 (``mid(3, 64, 7, 7)``),
  a pair's the JAX ``_mid``.
"""

import pytest

from _torch_resnet_util import eval_parity, make_cfg, rel_l2, train_parity
from video_graph_ssl_tpu.models.resnet2p1d import _mid as jax_mid
from video_graph_ssl_tpu_torch.models.resnet2p1d import STEM_MID, RESNET2P1D, mid

SHAPE = (2, 16, 64, 64, 3)
AUG = (2, 3, 4)
FAMILIES = {"resnet2p1d_10": 512, "resnet2p1d_50": 2048}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_eval_features_match_jax(name):
    feat, feat_ref, proj, proj_ref, _ = eval_parity(make_cfg(name, aug=AUG), SHAPE)
    assert feat.shape == (2, FAMILIES[name])
    assert rel_l2(feat, feat_ref) < 1e-5
    assert rel_l2(proj, proj_ref) < 1e-5


def test_train_forward_grads_and_bn_stats_match_jax(monkeypatch):
    c = make_cfg("resnet2p1d_10", dtype="float64", aug=AUG, sampler="relaxed_bernoulli")
    model = train_parity(c, SHAPE, monkeypatch)
    named = dict(model.named_parameters())
    enc = "model.encoder.base_model."
    for n in ("conv1_s.weight", "bn1_t.bias", "layer2.0.g_k.0.weight",
              "layer4.1.0.downsample.0.weight"):
        assert enc + n in named, n


def test_mid_widths_are_jax():
    assert STEM_MID == jax_mid(3, 64, 7, 7) == 110
    for cin, cout in ((64, 64), (64, 128), (128, 128), (256, 512), (512, 512)):
        assert mid(cin, cout) == jax_mid(cin, cout)
    block = RESNET2P1D["resnet2p1d_18"]().layer2[0]
    assert block.conv1_s.out_channels == jax_mid(64, 128)
    assert block.conv2_s.out_channels == jax_mid(128, 128)
