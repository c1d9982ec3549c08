"""The port's ``i3d_res50_nonlocal`` (``models/i3dnon.py``) against the JAX
package on the CPU.

* ``NonLocalBlock3D`` alone with ``w_bn``'s scale set non-zero (at init the
  block is the identity, which would hide any fault in the attention): the
  eval forward in fp32 within 1e-5, the train-mode forward, the input's and
  every parameter's gradient and the BN statistics in float64 (JAX's fp32
  BN pin lifted) within 1e-4.
* The full network (3, 4, 6, 3) in eval mode, graph blocks off, B = 1,
  16x32x32 (16 frames is the least that leaves T = 2 at stages 2-4), JAX
  variables carried through ``utils/jax_weights.py`` (strict): features and
  projections within 1e-5 in fp32; its non-local blocks sit on layer2.1 and
  layer2.3 in both packages.
* One partial-BN fine-tune step in lockstep with JAX (fp32, graph blocks
  off) on the (1, 4, 1, 1) network, which keeps the 4-block stack and both
  non-local blocks: the stem's and layer1.0's BN statistics move, no other
  (JAX ``i3dnon.py:170,189``); with graph blocks and their BNs
  (``GRAPH.BN_LAYER``) the live BNs are those and the graph blocks'.  (With
  graph blocks at JAX's init, their softmax over T = 2 frames is saturated
  at 32x32 and the fp32 gradients through it are rounding: the two packages
  then differ by 2e-3 in the small biases.  The float64 MoCo step of
  ``test_torch_i3dnon_steps.py`` holds the graph path.)
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import fill_variables, np_tree
from _torch_resnet_util import (downstream_lockstep, eval_parity, jax_bn_follows_input,
                                make_cfg, rel_l2)
from video_graph_ssl_tpu.models import build as jax_build
from video_graph_ssl_tpu.models import i3dnon as jax_i3dnon
from video_graph_ssl_tpu_torch.models import build, layers
from video_graph_ssl_tpu_torch.models.i3dnon import I3DResNetNonLocal, NonLocalBlock3D
from video_graph_ssl_tpu_torch.utils.jax_weights import _nonlocal

torch.set_num_threads(1)
NAME = "i3d_res50_nonlocal"
SMALL = (1, 4, 1, 1)


def use_layers(monkeypatch, layers):
    """Both registries build ``i3d_res50_nonlocal`` with ``layers``."""
    _, dim, aug = jax_build.BACKBONES_3D[NAME]
    monkeypatch.setitem(jax_build.BACKBONES_3D, NAME, (
        functools.partial(jax_i3dnon.I3DResNetNonLocal, layers=layers), dim, aug))
    monkeypatch.setitem(build.BACKBONES_3D, NAME, (
        functools.partial(I3DResNetNonLocal, layers), dim, aug))


def _block_sd(params, stats):
    out = {}
    _nonlocal(out, "m", params, stats)
    return {k[2:]: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def test_nonlocal_block_matches_jax():
    shape = (2, 4, 8, 8, 16)
    g = np.random.default_rng(0)
    x = g.standard_normal(shape).astype(np.float32)
    gout = g.standard_normal(shape).astype(np.float32)
    jm = jax_i3dnon.NonLocalBlock3D(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda v: jm.init({"params": jax.random.key(0)}, v), jnp.asarray(x))
    v = fill_variables(shapes, 1)
    assert float(np.abs(v["params"]["w_bn"]["bn"]["scale"]).min()) > 0.4
    ref = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx))(v, jnp.asarray(x)))
    port = NonLocalBlock3D(16, dtype=torch.float32)
    assert float(port.w_bn.weight.detach().abs().max()) == 0.0      # the identity at init
    port.load_state_dict(_block_sd(v["params"], v["batch_stats"]), strict=True)
    tx = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        out = port.eval()(tx).permute(0, 2, 3, 4, 1).numpy()
    assert rel_l2(ref, x) > 0.1           # the attention is on
    assert rel_l2(out, ref) < 1e-5

    with jax.enable_x64(), jax_bn_follows_input():
        jm64 = jax_i3dnon.NonLocalBlock3D(dtype=jnp.float64)

        def loss(p, xx):
            y, muts = jm64.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                                 train=True, mutable=["batch_stats"])
            return jnp.sum(y * gout), (y, muts["batch_stats"])

        (_, (y_ref, stats_ref)), (gp, gx) = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
                v["params"], jnp.asarray(x, jnp.float64))
        y_ref, gx = np.asarray(y_ref), np.asarray(gx)
        gp, stats_ref = np_tree(gp), np_tree(stats_ref)
    port = NonLocalBlock3D(16, dtype=torch.float64)
    port.load_state_dict(_block_sd(v["params"], v["batch_stats"]), strict=True)
    xa = torch.from_numpy(x).double().permute(0, 4, 1, 2, 3).requires_grad_()
    y = port.train()(xa)
    (y * torch.from_numpy(gout).double().permute(0, 4, 1, 2, 3)).sum().backward()
    assert rel_l2(y.detach().permute(0, 2, 3, 4, 1).numpy(), y_ref) < 1e-4
    assert rel_l2(xa.grad.permute(0, 2, 3, 4, 1).numpy(), gx) < 1e-4
    grads = _block_sd(gp, stats_ref)
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(k for k in grads if "running" not in k)
    # three biases have a zero gradient in exact arithmetic: phi's shifts
    # every logit of a row by theta . b, which the softmax does not see; g's
    # (the attention's rows sum to 1) and w_out's add a constant per channel
    # that train-mode w_bn subtracts.  What is left is the fp32 rounding of
    # the logits (both packages sum them in fp32), different in each: held
    # below 1e-3 of the largest gradient in both (the eval forward above
    # holds the biases themselves)
    top = max(float(g.norm()) for g in grads.values())
    for n, p in named.items():
        if n in ("phi.bias", "g.bias", "w_out.bias"):
            assert max(float(p.grad.norm()), float(grads[n].norm())) < 1e-3 * top
            continue
        assert rel_l2(p.grad.numpy(), grads[n].numpy()) < 1e-4, n
    for n, b in port.named_buffers():
        assert rel_l2(b.numpy(), grads[n].numpy()) < 1e-4, n


def test_full_depth_eval_matches_jax():
    c = make_cfg(NAME)
    feat, feat_ref, proj, proj_ref, params = eval_parity(c, (1, 16, 32, 32, 3))
    enc = params["model"]["encoder"]["base_model"]
    jax_nl = sorted(k for k, blk in enc.items() if "nonlocal" in blk)
    assert jax_nl == ["layer2_1", "layer2_3"]
    assert sum(k.startswith("layer3_") for k in enc) == 6
    model, _ = build.create_visual_model(c)
    port_nl = sorted(n for n, m in model.named_modules() if isinstance(m, NonLocalBlock3D))
    base = "model.encoder.base_model."
    assert port_nl == [base + "layer2.1.non_local", base + "layer2.3.non_local"]
    assert feat.shape == (1, 2048)
    assert rel_l2(feat, feat_ref) < 1e-5
    assert rel_l2(proj, proj_ref) < 1e-5


def test_partial_bn_finetune_step_matches_jax(monkeypatch):
    use_layers(monkeypatch, SMALL)
    c = make_cfg(NAME)
    c.DATASET.NUM_CLASS = 8
    c.MODEL.NO_PARTIALBN = False
    moved = downstream_lockstep(c, (2, 16, 32, 32, 3))
    live = ["bn1"] + [f"layer1.0.{b}" for b in ("bn1", "bn2", "bn3", "downsample.1")]
    assert moved == sorted(f"base_model.{m}.{r}" for m in live
                           for r in ("running_mean", "running_var"))
    model = I3DResNetNonLocal(aug_points=(2, 3, 4), graph_cfg={"bn_layer": True},
                              partial_bn=True)
    got = sorted(n for n, m in model.named_modules()
                 if isinstance(m, layers.BatchNorm) and not m.frozen)
    assert got == sorted(live + [f"layer{s}.0.{e}.0.1" for s in (2, 3, 4)
                                 for e in ("g_k", "g_q")])
    assert all(m.frozen for n, m in model.named_modules() if n.endswith("non_local.w_bn"))


@pytest.mark.parametrize("size,batch", [(112, 128), (224, 32)])
def test_kernel_times_geometry_is_jax_shapes(size, batch):
    """``kernel_times.geometry``'s K2 inputs (the graph blocks' inputs, whose
    shape the blocks keep) and K4 pool inputs (the stem conv's output,
    layer1's last block's output) against the JAX network's
    ``jax.eval_shape``; K1's q/k from K2's."""
    from video_graph_ssl_tpu_torch.kernel_times import geometry, k1_shape

    model = jax_i3dnon.I3DResNetNonLocal(layers=(3, 4, 6, 3), aug_points=(2, 3, 4),
                                         dtype=jnp.bfloat16)
    x = jax.ShapeDtypeStruct((batch, 16, size, size, 3), jnp.float32)
    variables = jax.eval_shape(lambda v: model.init({"params": jax.random.key(0)}, v), x)
    _, inter = jax.eval_shape(lambda v, xx: model.apply(
        v, xx, capture_intermediates=True, mutable=["intermediates"]), variables, x)
    inter = inter["intermediates"]
    k1, k2, pools, seps = geometry(size, batch, NAME)
    assert k2 == [tuple(inter[f"graph_aug_{s}"]["__call__"][0].shape) for s in (2, 3, 4)]
    assert k1 == [k1_shape(s) for s in k2] and seps == []
    assert [p[2] for p in pools] == [tuple(inter["conv1"]["__call__"][0].shape),
                                     tuple(inter["layer1_2"]["__call__"][0].shape)]
    assert [(p[3], p[4], p[5]) for p in pools] == [((3, 3, 3), (2, 2, 2), (1, 1, 1)),
                                                   ((3, 1, 1), (2, 1, 1), (1, 0, 0))]
    if size == 112:
        assert [d for _, _, d in k1] == [25088, 12544, 4608]
        assert [h * w * c for _, _, h, w, c in k2] == [200704, 100352, 50176]
