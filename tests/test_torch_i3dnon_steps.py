"""``i3d_res50_nonlocal``'s train mode and GCA MoCo step against the JAX
package on the CPU, on the (1, 4, 1, 1) network of both packages (the
4-block stack, so both non-local blocks, on layer2.1 and layer2.3; the full
network's train-mode run costs a minute or more per test on one core).

* Train mode in float64 (JAX's fp32 BN pin lifted), graph blocks at 2, 3, 4
  with the relaxed-Bernoulli sampler and JAX's draws injected, every
  non-local ``w_bn`` scale non-zero (``fill_variables``): the output, every
  parameter gradient and every BN statistic within 1e-4 (the three
  non-local biases whose gradient is zero in exact arithmetic below 1e-3 of
  the largest in both); B = 2, 16x64x64
  (stage 4 sees 2x2 frames: ``test_torch_backbones_resnet3d.py`` says why
  not 32x32).  The three blocks all see T = 2 frames, so JAX's draws are
  keyed by block name and handed to the port's blocks in stage order.
* One GCA MoCo step in lockstep with JAX in float64 from JAX's initial
  state, with every non-local ``w_bn`` scale set to 0.5 in both encoders
  (at 0 the attention would take no gradient): loss, every parameter, the
  EMA encoder and the queue within 1e-4; B = 4, 16x48x48.
"""

import jax
import numpy as np

from _torch_resnet_util import make_cfg, moco_lockstep, train_parity
from test_torch_i3dnon import NAME, SMALL, use_layers

BLOCKS = ["graph_aug_2", "graph_aug_3", "graph_aug_4"]
# zero gradients in exact arithmetic (test_torch_i3dnon.py says why): each
# package's is its own rounding
ZERO_GRAD = ("non_local.phi.bias", "non_local.g.bias", "non_local.w_out.bias")


def test_train_forward_grads_and_bn_stats_match_jax(monkeypatch):
    use_layers(monkeypatch, SMALL)
    c = make_cfg(NAME, dtype="float64", aug=(2, 3, 4), sampler="relaxed_bernoulli")
    model = train_parity(c, (2, 16, 64, 64, 3), monkeypatch, blocks=BLOCKS,
                         zero_grad=ZERO_GRAD)
    named = dict(model.named_parameters())
    enc = "model.encoder.base_model."
    for n in ("conv1.weight", "layer2.0.g_q.0.weight", "layer2.1.1.non_local.theta.weight",
              "layer2.1.3.non_local.w_bn.weight", "layer4.1.0.downsample.0.weight"):
        assert enc + n in named, n
    assert float(named[enc + "layer2.1.1.non_local.phi.weight"].grad.norm()) > 0.0


def with_nonlocal_scale(params):
    """``params`` with every non-local ``w_bn`` scale at 0.5."""
    def scale(path, leaf):
        keys = [str(getattr(k, "key", k)) for k in path]
        return leaf * 0 + 0.5 if "w_bn" in keys and keys[-1] == "scale" else leaf
    return jax.tree_util.tree_map_with_path(scale, params)


def test_gca_moco_step_lockstep_with_jax(monkeypatch):
    use_layers(monkeypatch, SMALL)
    c = make_cfg(NAME, dtype="float64", aug=(2, 3, 4), sampler="relaxed_bernoulli")
    c.CROSS.FEAT_DIM = 32
    c.CONTRAST.NCE_K = 16
    # NCE_T 1.0: see test_torch_backbones_2d_steps.py's MoCo step
    c.CONTRAST.NCE_T = 1.0
    drawn = moco_lockstep(c, (4, 2, 16, 48, 48, 3), monkeypatch, blocks=BLOCKS,
                          tweak=with_nonlocal_scale, zero_grad=ZERO_GRAD)
    assert sorted(drawn) == BLOCKS
    assert all(np.asarray(u).shape == (4, 2, 2) for u in drawn.values())
