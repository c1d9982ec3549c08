"""The port's downstream model against the JAX package on the CPU.

* Partial BN: every BN after ``stem_0`` (tiny3d: after ``stage0``) runs on
  its running statistics in train mode and keeps them; the graph blocks'
  BNs stay live.  On a small S3D + graph model (B = 2, T = 8, 32x32, graph
  blocks at 5 and 9, sampler none) and on tiny3d, the JAX ``VideoModel``'s
  seeded variables carried through the weight bridge give the same logits,
  every parameter gradient and the same BN statistics after a train-mode
  pass, and only ``stem_0``'s (``stage0``'s) statistics move.  fp32: with
  every deep BN frozen the deep stages are affine, and train-mode BN's
  amplification of rounding over a few values per channel (which sends the
  pretrain comparisons to float64, ``test_torch_models.py``) is gone.
* A frozen ``SepConv3d`` with ``TPU.SEPCONV_FUSED`` takes the plain
  running-statistics composition, never K5's train-mode backward.
* ``VideoModel``: eval logits and features after the weight carry,
  ``export_downstream_to_torch``'s dict loaded ``strict=True``, the
  ``new_fc`` init, the keyed dropout's keep rate and 1/(1-p) scale, and
  ``create_video_model``'s options.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import fill_variables, np_tree, rel_l2
from video_graph_ssl_tpu.config import cfg as jax_cfg
from video_graph_ssl_tpu.models import create_video_model as jax_create
from video_graph_ssl_tpu.utils.ckpt_convert import export_downstream_to_torch
from video_graph_ssl_tpu_torch.models import layers
from video_graph_ssl_tpu_torch.models.build import create_video_model
from video_graph_ssl_tpu_torch.models.wrappers import keyed_dropout
from video_graph_ssl_tpu_torch.ops import fused_sepconv
from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug
from video_graph_ssl_tpu_torch.utils.jax_weights import (downstream_state_dict,
                                                         load_downstream_weights)

torch.set_num_threads(1)
B, T = 2, 8
NUM_CLASS = 8
TOL = 1e-4


def ds_cfg(backbone="S3D", partial_bn=True, aug=(5, 9), dtype="float32", dropout=0.0):
    c = jax_cfg.clone()
    c.MODEL.BACKBONE = backbone
    c.MODEL.BACKBONE_TYPE = "3D"
    c.MODEL.AUG_FLAG = bool(aug)
    c.MODEL.DROPOUT = dropout
    c.MODEL.NO_PARTIALBN = not partial_bn
    c.GRAPH.AUG_POINTS = tuple(aug) if backbone == "S3D" else ()
    c.GRAPH.SAMPLER = "none"
    c.DATASET.NUM_CLASS = NUM_CLASS
    c.TPU.COMPUTE_DTYPE = dtype
    c.TPU.PACK_POINTWISE = False
    return c


def setup(c, hw, seed=0):
    """(clips, cotangent, params, batch_stats) as numpy."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((B, T, hw, hw, 3)).astype(np.float32)
    gout = g.standard_normal((B, NUM_CLASS)).astype(np.float32)
    model, _ = jax_create(c)
    shapes = jax.eval_shape(lambda v: model.init({"params": jax.random.key(0)}, v),
                            jnp.asarray(x))
    v = fill_variables(shapes, seed + 1)
    return x, gout, v["params"], v["batch_stats"]


def port(c, params, stats):
    model, _ = create_video_model(c)
    load_downstream_weights(model, params, stats)
    return model


def _stats(model):
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


@pytest.mark.parametrize("backbone,hw,live", [("S3D", 32, "base_model.base.0."),
                                              ("tiny3d", 16, "base_model.stage0.")])
def test_partial_bn_train_pass_matches_jax(backbone, hw, live):
    c = ds_cfg(backbone)
    x, gout, params, stats = setup(c, hw)
    jmodel, _ = jax_create(c)

    def loss(p):
        out, muts = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                 train=True, rngs={"graph": jax.random.key(1),
                                                   "dropout": jax.random.key(2)},
                                 mutable=["batch_stats"])
        return jnp.sum(out * gout), (out, muts["batch_stats"])

    (_, (out_ref, new_stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model = port(c, params, stats).train()
    before = _stats(model)
    out = model(torch.from_numpy(x))
    (out * torch.from_numpy(gout)).sum().backward()
    assert rel_l2(out.detach().numpy(), out_ref) < TOL

    ref = downstream_state_dict(np_tree(grads), np_tree(new_stats), backbone)
    named = dict(model.named_parameters())
    assert len(named) == len([k for k in ref if "running" not in k])
    floor = 1e-9 * max(np.linalg.norm(ref[n]) for n in named)
    for name, p in named.items():
        assert p.grad is not None, name
        diff = np.linalg.norm(p.grad.numpy().astype(np.float64) - ref[name])
        assert diff < TOL * max(np.linalg.norm(ref[name]), floor), name
    after = _stats(model)
    moved = sorted(k for k in after if not torch.equal(after[k], before[k]))
    assert moved and all(k.startswith(live) for k in moved), moved
    # mean and var of stem_0's two BNs, of stage0's one
    assert len(moved) == (4 if backbone == "S3D" else 2)
    for k in after:
        assert rel_l2(after[k].numpy(), ref[k]) < TOL, k


def test_partial_bn_off_keeps_every_bn_live():
    c = ds_cfg("tiny3d", partial_bn=False, aug=())
    x, _, params, stats = setup(c, 16)
    model = port(c, params, stats).train()
    before = _stats(model)
    with torch.no_grad():
        model(torch.from_numpy(x))
    after = _stats(model)
    assert all(not torch.equal(after[k], before[k]) for k in after)


def test_partial_bn_freezes_stages_after_the_stem_not_the_graph():
    c = ds_cfg("S3D", aug=(5, 9))
    c.GRAPH.BN_LAYER = True
    model, _ = create_video_model(c)
    base = model.base_model.base
    graph_bns = {id(m) for g in model.modules() if isinstance(g, TemporalGraphAug)
                 for m in g.modules() if isinstance(m, layers.BatchNorm)}
    assert len(graph_bns) == 4
    for name, m in model.named_modules():
        if isinstance(m, layers.BatchNorm):
            want = id(m) not in graph_bns and not name.startswith("base_model.base.0.")
            assert m.frozen == want, name
    assert not base[0].bn_s.frozen and not base[0].bn_t.frozen
    live, _ = create_video_model(ds_cfg("S3D", partial_bn=False))
    assert not any(m.frozen for m in live.modules() if isinstance(m, layers.BatchNorm))


def test_frozen_bn_uses_running_stats_and_passes_gradients():
    g = torch.Generator().manual_seed(0)
    bn = layers.BatchNorm(6, momentum=0.999, eps=1e-3)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(6, generator=g))
        bn.running_var.copy_(torch.rand(6, generator=g) + 0.5)
        bn.weight.copy_(torch.rand(6, generator=g) + 0.5)
    bn.frozen = True
    bn.train()
    x = torch.randn(3, 6, 2, 4, 4, generator=g, requires_grad=True)
    y = bn(x)
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    want = ((x - rm.reshape(1, -1, 1, 1, 1)) / torch.sqrt(rv.reshape(1, -1, 1, 1, 1) + 1e-3)
            * bn.weight.reshape(1, -1, 1, 1, 1) + bn.bias.reshape(1, -1, 1, 1, 1))
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    y.sum().backward()
    assert torch.equal(bn.running_mean, rm) and torch.equal(bn.running_var, rv)
    assert bn.weight.grad is not None and bn.bias.grad is not None
    torch.testing.assert_close(x.grad, (bn.weight / torch.sqrt(rv + 1e-3)).reshape(
        1, -1, 1, 1, 1).expand_as(x), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("frozen", [False, True])
def test_frozen_sepconv_takes_the_plain_composition(monkeypatch, frozen):
    calls = []
    real = fused_sepconv.fused_sepconv_train

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fused_sepconv, "fused_sepconv_train", spy)
    sep = layers.SepConv3d(8, 8, 3, 1, 1, dtype=torch.float32, fused_bwd=True)
    if frozen:
        layers.freeze_bn_(sep)
    sep.train()
    x = torch.randn(2, 8, 4, 6, 6).contiguous(memory_format=torch.channels_last_3d)
    y = sep(x)
    assert len(calls) == (0 if frozen else 1)
    if frozen:
        ref = sep.eval()(x)
        torch.testing.assert_close(y, ref, rtol=0, atol=0)


def test_video_model_eval_logits_and_features_match_jax():
    c = ds_cfg("S3D", aug=(5, 9))
    x, _, params, stats = setup(c, 32)
    jmodel, _ = jax_create(c)
    v = {"params": params, "batch_stats": stats}
    logits_ref, feat_ref = jax.jit(lambda xx: (jmodel.apply(v, xx), jmodel.apply(
        v, xx, method=jmodel.encode)))(jnp.asarray(x))
    model = port(c, params, stats).eval()
    with torch.no_grad():
        logits, feat = model(torch.from_numpy(x)), model.encode(torch.from_numpy(x))
    assert logits.shape == (B, NUM_CLASS) and feat.shape == (B, 1024)
    assert logits.dtype == torch.float32
    assert rel_l2(logits.numpy(), logits_ref) < 1e-5
    assert rel_l2(feat.numpy(), feat_ref) < 1e-5


def test_export_downstream_to_torch_loads_strictly():
    c = ds_cfg("S3D", aug=(5, 9))
    _, _, params, stats = setup(c, 32)
    ref = export_downstream_to_torch(params, stats)
    ours = downstream_state_dict(params, stats, "S3D")
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    model, _ = create_video_model(c)
    assert sorted(model.state_dict()) == sorted(ref)
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in ref.items()},
                          strict=True)
    assert {k.split(".")[0] for k in ref} == {"base_model", "new_fc"}


def test_new_fc_init_is_normal_0_001_with_zero_bias():
    c = ds_cfg("S3D", aug=())
    c.DATASET.NUM_CLASS = 101
    model, dim = create_video_model(c)
    w = model.new_fc.weight.detach()
    assert dim == 1024 and w.shape == (101, 1024) and w.dtype == torch.float32
    assert abs(float(w.std()) - 0.001) < 2e-5 and abs(float(w.mean())) < 2e-5
    assert not model.new_fc.bias.detach().any()


@pytest.mark.parametrize("p", [0.3, 0.7])
def test_keyed_dropout_keep_rate_and_scale(p):
    x = torch.ones(512, 1024)
    y = keyed_dropout(x, p, seed=5)
    kept = y != 0
    rate = float(kept.float().mean())
    n = x.numel()
    assert abs(rate - (1 - p)) < 5 * (p * (1 - p) / n) ** 0.5
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1.0 / (1.0 - p)))
    assert torch.equal(keyed_dropout(x, p, seed=5), y)          # keyed on the seed
    assert not torch.equal(keyed_dropout(x, p, seed=6), y)
    # a rank's rows are those rows of the global batch's draw
    part = keyed_dropout(x[128:256], p, seed=5, rows=(128, 512))
    assert torch.equal(part, y[128:256])


def test_dropout_runs_in_train_mode_only():
    c = ds_cfg("tiny3d", aug=(), dropout=0.5)
    model, _ = create_video_model(c)
    x = torch.randn(B, 4, 16, 16, 3)
    model.eval()
    with torch.no_grad():
        a = model.encode(x)
        model.dropout = 0.0
        assert torch.equal(model.encode(x), a)
        model.train()
        plain = model.encode(x, graph_seed=3)
        model.dropout = 0.5
        f = model.encode(x, graph_seed=3)
    assert torch.equal(model.encode(x, graph_seed=3).detach(), f)
    dropped = (f == 0) & (plain != 0)
    assert dropped.any() and (f != 0).any()
    torch.testing.assert_close(f, torch.where(f == 0, f, plain * 2.0))


def test_create_video_model_options():
    c = ds_cfg("S3D", aug=())
    c.DATASET.NUM_CLASS = 51
    c.MODEL.DROPOUT = 0.7
    c.TPU.COMPUTE_DTYPE = "bfloat16"
    model, _ = create_video_model(c)
    assert model.new_fc.out_features == 51 and model.dropout == 0.7
    assert model.base_model.dtype == torch.bfloat16 and model.base_model.aug_points == ()
    c.MODEL.AUG_FLAG = True
    c.GRAPH.AUG_POINTS = ()
    assert create_video_model(c)[0].base_model.aug_points == (5, 9, 14)
    c.TPU.SEPCONV_FUSED = True
    fused = create_video_model(c)[0]
    seps = [m for m in fused.modules() if isinstance(m, layers.SepConv3d) and m.fused]
    assert len(seps) == 18 and all(m.bn_s.frozen for m in seps)
    # the downstream classifier ignores CROSS.MODALITY, as in JAX: a CMC
    # config builds the one-encoder VideoModel (fine-tuned from model_1)
    cmc = ds_cfg("S3D", aug=())
    cmc.CROSS.MODALITY = "visual+audio"
    plain = ds_cfg("S3D", aug=())
    assert sorted(create_video_model(cmc)[0].state_dict()) == sorted(
        create_video_model(plain)[0].state_dict())
    other = ds_cfg("S3D", aug=())
    other.MODEL.BACKBONE = "resnet50"
    with pytest.raises(NotImplementedError, match="not ported"):
        create_video_model(other)
