"""The port's ``resnet2p1d_50`` (R(2+1)D bottleneck blocks) in train mode
against the JAX package on the CPU, in float64 (JAX's fp32 BN pin lifted,
``_torch_resnet_util``): the output, every parameter gradient and every BN
statistic within 1e-4.  Eval features: ``test_torch_backbones_r2plus1d.py``.

B = 4, T = 16, 64x64, in two cases: graph blocks at 2 and 3 with the
relaxed-Bernoulli sampler on (JAX's draws injected), and at 2, 3 and 4 with
the sampler off.  With the sampler on at stage 4 (two frames) that block's
q/k gradients are chaotic in fp32 rounding: the port against itself, with
a 6e-8 relative perturbation of the adjacency, moves layer4's g_k gradient
by 2.6e-2 (at B = 2 the small BN biases of stages 1-4 by up to 2e-2), as
far as JAX's lies from the port's.  In the two cases the packages agree to
8e-6 and 1.6e-5.
"""

import pytest

from _torch_resnet_util import make_cfg, train_parity

SHAPE = (4, 16, 64, 64, 3)


@pytest.mark.parametrize("aug,sampler", [((2, 3), "relaxed_bernoulli"), ((2, 3, 4), "none")])
def test_train_forward_grads_and_bn_stats_match_jax(aug, sampler, monkeypatch):
    c = make_cfg("resnet2p1d_50", dtype="float64", aug=aug, sampler=sampler)
    model = train_parity(c, SHAPE, monkeypatch)
    named = dict(model.named_parameters())
    enc = "model.encoder.base_model."
    stage4 = "layer4.1.0" if 4 in aug else "layer4.0"
    for n in ("conv1_s.weight", "bn1_t.bias", "layer2.0.g_k.0.weight",
              "layer3.0.gcns.0.conv.weight", f"{stage4}.conv2_s.weight",
              f"{stage4}.downsample.0.weight"):
        assert enc + n in named, n
