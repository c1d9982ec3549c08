"""The port's S3D + graph model against the JAX package on the CPU.

A JAX ``GraphWrapper`` (S3D + graph blocks, sampler none) gets seeded
numpy variables, carried into the port through the weight bridge
(``utils/jax_weights.py``, strict load); both run the same clips, B=2, T=8,
32x32 (stage 14 needs at least 2x2 spatial input, so it carries no graph
block at this size).

Precision.  Eval features are compared in fp32 with graph blocks at stages
5 and 9.  Train mode normalises the deep stages over 2-16 values per
channel, which amplifies rounding: in fp32 the two packages sit ~1e-2 apart
(rel-L2 of the output, measured) while computing the same function.  So
the train-mode comparisons run both packages in float64
(``jax.enable_x64``).  The graph blocks still round their similarity,
softmax and propagation to fp32 in both packages (the JAX einsums'
``preferred_element_type``), and the two softmax implementations differ in
the last fp32 bit; behind stage 9 that is amplified past 1e-4 (the port
against itself with 6e-8 relative noise on stage 9's similarity: 1.8e-4
in the output, up to 1e-1 in some parameter gradients).  So the train-mode
comparisons carry the graph block at stage 5 only; stage 9's block is
covered by the eval comparison and by tests/test_torch_graph_ops.py.

Max-pool gradients (``test_torch_models_grads.py``): torch routes a tied
window's gradient to its first maximum, the JAX where-chain along each
axis; windows tie almost only on ReLU zeros, whose upstream ReLU gradient
is 0, so the gradients agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import fill_variables, np_tree, rel_l2
from video_graph_ssl_tpu.config import cfg as jax_cfg
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu.utils.ckpt_convert import export_pretrain_to_torch
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.utils.jax_weights import (
    load_pretrain_weights, pretrain_state_dict)

torch.set_num_threads(1)
B, T, H, W = 2, 8, 32, 32
TRAIN_AUG = (5,)   # graph blocks of the float64 train-mode comparisons


def s3d_cfg(dtype: str = "float32", aug=(5, 9)):
    c = jax_cfg.clone()
    c.MODEL.BACKBONE = "S3D"
    c.MODEL.BACKBONE_TYPE = "3D"
    c.MODEL.AUG_FLAG = True
    c.MODEL.DROPOUT = 0.0
    c.GRAPH.AUG_POINTS = tuple(aug)
    c.GRAPH.SAMPLER = "none"
    c.CONTRAST.MEM_TYPE = "moco"
    c.CROSS.FEAT_DIM = 128
    c.TPU.COMPUTE_DTYPE = dtype
    # Packed pointwise convs are the same math on the same parameters
    # (tests/test_pack_pointwise.py), but their BN statistics are always
    # fp32; the unpacked blocks keep float64 runs float64 throughout.
    c.TPU.PACK_POINTWISE = False
    return c


def s3d_setup(seed: int = 0, aug=(5, 9)):
    """(clips, cotangent, params, batch_stats) as numpy, from ``seed``."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((B, T, H, W, 3)).astype(np.float32)
    gout = g.standard_normal((B, 128)).astype(np.float32)
    model, _ = jax_create(s3d_cfg(aug=aug))
    shapes = jax.eval_shape(lambda v: model.init({"params": jax.random.key(0)}, v),
                            jnp.asarray(x))
    variables = fill_variables(shapes, seed + 1)
    return x, gout, variables["params"], variables["batch_stats"]


def port_model(dtype: str, params, stats, aug=(5, 9)):
    model, _ = create_visual_model(s3d_cfg(dtype, aug))
    load_pretrain_weights(model, params, stats, "S3D")
    return model


def jax_train_apply(model, params, stats, x):
    out, muts = model.apply({"params": params, "batch_stats": stats}, x,
                            train=True, rngs={"graph": jax.random.key(1),
                                              "dropout": jax.random.key(2)},
                            mutable=["batch_stats"])
    return out, muts["batch_stats"]


@pytest.fixture(scope="module")
def setup():
    return s3d_setup()


def test_weight_bridge_equals_export_pretrain_to_torch(setup):
    _, _, params, stats = setup
    ours = pretrain_state_dict(params, stats, "S3D")
    ref = export_pretrain_to_torch(params, stats, "moco")
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    model, _ = create_visual_model(s3d_cfg())
    assert sorted(model.state_dict()) == sorted(ref)
    load_pretrain_weights(model, params, stats, "S3D")   # strict


def test_s3d_graph_eval_features_match_jax(setup):
    x, _, params, stats = setup
    jmodel, _ = jax_create(s3d_cfg())

    @jax.jit
    def eval_fn(p, s, xx):
        v = {"params": p, "batch_stats": s}
        return jmodel.apply(v, xx, method=jmodel.encode), jmodel.apply(v, xx)

    feat_ref, proj_ref = eval_fn(params, stats, jnp.asarray(x))
    model = port_model("float32", params, stats).eval()
    with torch.no_grad():
        feat = model.encode(torch.from_numpy(x))
        proj = model(torch.from_numpy(x))
    assert feat.shape == (B, 1024) and proj.shape == (B, 128)
    assert rel_l2(feat.numpy(), feat_ref) < 1e-5
    assert rel_l2(proj.numpy(), proj_ref) < 1e-5


def test_s3d_graph_train_forward_and_bn_stats_match_jax():
    x, _, params, stats = s3d_setup(aug=TRAIN_AUG)
    with jax.enable_x64():
        jmodel, _ = jax_create(s3d_cfg("float64", TRAIN_AUG))
        out_ref, new_stats = jax.jit(
            lambda p, s, xx: jax_train_apply(jmodel, p, s, xx))(
                params, stats, jnp.asarray(x, jnp.float64))
        out_ref, new_stats = np.asarray(out_ref), np_tree(new_stats)
    model = port_model("float64", params, stats, TRAIN_AUG).train()
    with torch.no_grad():
        out = model(torch.from_numpy(x).double())
    assert rel_l2(out.numpy(), out_ref) < 1e-4

    ref_sd = pretrain_state_dict(params, new_stats, "S3D")
    bufs = dict(model.named_buffers())
    assert len(bufs) == len([k for k in ref_sd if "running" in k])
    for name, buf in bufs.items():
        assert rel_l2(buf.numpy(), ref_sd[name]) < 1e-4, name


def test_s3d_head_pool_halves_endpoint_frames_like_jax():
    """24 frames leave T' = 3 at the head, where the reference pooling gives
    the endpoint frames half weight (at T = 8, T' = 1 and it is a mean)."""
    g = np.random.default_rng(5)
    x = g.standard_normal((B, 24, H, W, 3)).astype(np.float32)
    aug = (5,)
    jmodel, _ = jax_create(s3d_cfg(aug=aug))
    shapes = jax.eval_shape(lambda v: jmodel.init({"params": jax.random.key(0)}, v),
                            jnp.asarray(x))
    variables = fill_variables(shapes, 6)
    feat_ref = jax.jit(lambda v, xx: jmodel.apply(v, xx, method=jmodel.encode))(
        variables, jnp.asarray(x))
    model = port_model("float32", variables["params"], variables["batch_stats"], aug).eval()
    with torch.no_grad():
        feat = model.encode(torch.from_numpy(x))
    assert rel_l2(feat.numpy(), feat_ref) < 1e-5
