"""The port's space-to-depth stem (``TPU.STEM_S2D`` full / spatial) against
the JAX package's on the CPU.

The fold map is JAX's bit for bit; ``SepConvS2D`` matches JAX's module and
its own standard ``SepConv3d(64, 7, 2, 3)`` on the folded weights (eval
fp32 at 1e-5 rel-L2; train mode in float64 for the gradients and BN
statistics at 1e-9); S3D and S3DG with the stem match JAX's at T = 8, 32x32
through the weight bridge (eval fp32 at 1e-5); the reference-checkpoint
converter folds as JAX's ``convert_torch_s3d(stem_s2d=...)`` does; and a
``block`` remat step with the stem equals the same step without remat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import fill_variables, np_tree, rel_l2
from video_graph_ssl_tpu.config import cfg as jax_cfg
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu.models import layers as jlayers
from video_graph_ssl_tpu.models.s3d import stem_params_to_s2d as jax_stem_to_s2d
from video_graph_ssl_tpu.utils.torch_interop import convert_torch_s3d
from video_graph_ssl_tpu_torch.models import layers
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.models.s3d import stem_params_to_s2d, to_ncdhw
from video_graph_ssl_tpu_torch.utils import jax_weights
from video_graph_ssl_tpu_torch.utils.ckpt_convert import port_encoder, reference_encoder

torch.set_num_threads(1)
B, T, H, W = 2, 8, 32, 32
MODES = ["full", "spatial"]


@pytest.mark.parametrize("axes,shape", [("hw", (1, 7, 7, 3, 64)), ("t", (7, 1, 1, 64, 64)),
                                        ("hw", (1, 7, 7, 10, 16))])
def test_fold_map_is_jax_bit_for_bit(axes, shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jlayers.fold_stem_kernel_s2d(w, axes))
    got = layers.fold_stem_kernel_s2d(w, axes)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # the torch-layout fold: (F, C, kt, kh, kw) around the same map
    tw = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
    folded = layers.fold_stem_weight(tw, axes)
    assert np.array_equal(folded.numpy(), want.transpose(4, 3, 0, 1, 2))
    assert layers.fold_stem_weight(tw.bfloat16(), axes).dtype == torch.bfloat16


def test_space_to_depth_channel_order_is_jax():
    x = np.random.default_rng(1).standard_normal((2, 4, 6, 8, 5)).astype(np.float32)
    xt = to_ncdhw(torch.from_numpy(x))
    hw = layers.space_to_depth_hw(xt).permute(0, 2, 3, 4, 1)
    t = layers.space_to_depth_t(xt).permute(0, 2, 3, 4, 1)
    assert np.array_equal(hw.numpy(), np.asarray(jlayers.space_to_depth_hw(jnp.asarray(x))))
    assert np.array_equal(t.numpy(), np.asarray(jlayers.space_to_depth_t(jnp.asarray(x))))


def _jax_stem(mode, temporal_bias, dtype, x):
    mod = jlayers.SepConvS2D(64, temporal_bias=temporal_bias,
                             temporal_s2d=mode == "full", dtype=dtype, param_dtype=dtype)
    shapes = jax.eval_shape(lambda v: mod.init(jax.random.key(0), v), jnp.asarray(x, dtype))
    return mod, fill_variables(shapes, 3)


def _port_stem(mode, temporal_bias, dtype, params, stats):
    sd = {}
    jax_weights._sep(sd, "s", params, stats)
    m = layers.SepConvS2D(3, 64, temporal_bias=temporal_bias, temporal_s2d=mode == "full",
                          dtype=dtype)
    m.load_state_dict({k[2:]: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                      strict=True)
    return m.to(dtype) if dtype == torch.float64 else m


def _standard_stem(stem: layers.SepConvS2D, mode, temporal_bias, dtype):
    """A standard stem drawn from a seed, its fold loaded into ``stem``."""
    std = layers.SepConv3d(3, 64, 7, 2, 3, dtype=dtype, temporal_bias=temporal_bias)
    layers.init_params_(std, torch.Generator().manual_seed(5))
    sd = stem_params_to_s2d({f"base.0.{k}": v for k, v in std.state_dict().items()}, mode)
    stem.load_state_dict({k[len("base.0."):]: v for k, v in sd.items()}, strict=True)
    return std.to(dtype) if dtype == torch.float64 else std


@pytest.mark.parametrize("temporal_bias", [False, True], ids=["s3d", "s3dg"])
@pytest.mark.parametrize("mode", MODES)
def test_sepconv_s2d_eval_matches_jax_and_standard_stem(mode, temporal_bias):
    x = np.random.default_rng(2).standard_normal((B, T, H, W, 3)).astype(np.float32)
    mod, v = _jax_stem(mode, temporal_bias, jnp.float32, x)
    want = np.asarray(mod.apply(v, jnp.asarray(x), train=False))
    stem = _port_stem(mode, temporal_bias, torch.float32, v["params"], v["batch_stats"]).eval()
    with torch.no_grad():
        got = stem(to_ncdhw(torch.from_numpy(x))).permute(0, 2, 3, 4, 1)
    assert got.shape == want.shape == (B, T // 2, H // 2, W // 2, 64)
    assert rel_l2(got.numpy(), want) < 1e-5
    std = _standard_stem(stem, mode, temporal_bias, torch.float32).eval()
    with torch.no_grad():
        a = std(to_ncdhw(torch.from_numpy(x)))
        b = stem(to_ncdhw(torch.from_numpy(x)))
    assert rel_l2(b.numpy(), a.numpy()) < 1e-5


@pytest.mark.parametrize("temporal_bias", [False, True], ids=["s3d", "s3dg"])
@pytest.mark.parametrize("mode", MODES)
def test_sepconv_s2d_train_grads_and_stats_float64(mode, temporal_bias):
    g = np.random.default_rng(3)
    x = g.standard_normal((B, T, H, W, 3))
    gout = g.standard_normal((B, T // 2, H // 2, W // 2, 64))
    with jax.enable_x64():
        mod, v = _jax_stem(mode, temporal_bias, jnp.float64, x)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v["params"])
        stats = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                       v["batch_stats"])

        def loss(p, xx):
            out, muts = mod.apply({"params": p, "batch_stats": stats}, xx, train=True,
                                  mutable=["batch_stats"])
            return jnp.sum(out * gout), (out, muts["batch_stats"])

        (_, (out_ref, new_stats)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        out_ref, gx = np.asarray(out_ref), np.asarray(gx)
        new_stats, gp = np_tree(new_stats), jax.tree_util.tree_map(np.asarray, gp)

    stem = _port_stem(mode, temporal_bias, torch.float64, v["params"], v["batch_stats"])
    stem.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = stem(to_ncdhw(xt)).permute(0, 2, 3, 4, 1)
    (out * torch.from_numpy(gout)).sum().backward()
    assert rel_l2(out.detach().numpy(), out_ref) < 1e-9
    assert rel_l2(xt.grad.numpy(), gx) < 1e-9
    grads, new = {}, {}
    jax_weights._sep(grads, "s", gp, new_stats)
    jax_weights._sep(new, "s", params, new_stats)
    # a conv bias before a train-mode BN has a zero gradient: its rounding
    # noise is held to the largest gradient's scale
    floor = 1e-6 * max(np.linalg.norm(g) for g in grads.values())
    for name, p in stem.named_parameters():
        ref = grads["s." + name]
        diff = np.linalg.norm(p.grad.numpy() - ref)
        assert diff < 1e-9 * max(np.linalg.norm(ref), floor), name
    for name, buf in stem.named_buffers():
        assert rel_l2(buf.numpy(), new["s." + name]) < 1e-7, name

    # the same pass through the standard stem on the unfolded weights
    std = _standard_stem(stem, mode, temporal_bias, torch.float64).train()
    stem.zero_grad()
    x2 = torch.from_numpy(x)
    (std(to_ncdhw(x2)) * to_ncdhw(torch.from_numpy(gout))).sum().backward()
    (stem(to_ncdhw(x2)) * to_ncdhw(torch.from_numpy(gout))).sum().backward()
    folded = stem_params_to_s2d({f"base.0.{k}": p.grad for k, p in std.named_parameters()},
                                mode)
    for name, p in stem.named_parameters():
        if "weight" in name and "conv" in name:
            # the zero tap of the fold gets a gradient of its own
            mask = stem_params_to_s2d({"base.0." + name: torch.ones_like(
                dict(std.named_parameters())[name])}, mode)["base.0." + name] != 0
            assert rel_l2(p.grad[mask].numpy(), folded["base.0." + name][mask].numpy()) < 1e-9
        else:
            ref = folded["base.0." + name].numpy()
            diff = np.linalg.norm(p.grad.numpy() - ref)
            assert diff < 1e-9 * max(np.linalg.norm(ref), floor), name
    for (n1, a), (_, b) in zip(std.named_buffers(), stem.named_buffers()):
        assert rel_l2(b.numpy(), a.numpy()) < 1e-12, n1


def test_sepconv_s2d_refuses_odd_extents():
    stem = layers.SepConvS2D(3, 64, dtype=torch.float32).eval()
    for shape in ((1, 3, 7, 8, 8), (1, 3, 8, 9, 8), (1, 3, 8, 8, 7)):
        with pytest.raises(ValueError, match="even"):
            stem(torch.zeros(shape))


def s2d_cfg(backbone, mode, dtype="float32"):
    c = jax_cfg.clone()
    c.MODEL.BACKBONE = backbone
    c.MODEL.BACKBONE_TYPE = "3D"
    c.MODEL.AUG_FLAG = True
    c.MODEL.DROPOUT = 0.0
    c.GRAPH.AUG_POINTS = (5,)
    c.GRAPH.SAMPLER = "none"
    c.CONTRAST.MEM_TYPE = "moco"
    c.CROSS.FEAT_DIM = 128
    c.TPU.COMPUTE_DTYPE = dtype
    c.TPU.PACK_POINTWISE = False
    c.TPU.STEM_S2D = mode
    return c


@pytest.mark.parametrize("backbone", ["S3D", "S3DG"])
@pytest.mark.parametrize("mode", MODES)
def test_s3d_with_s2d_stem_matches_jax(backbone, mode):
    """The whole encoder + head in eval, JAX's folded tree through the
    weight bridge with ``load_state_dict(strict=True)``."""
    x = np.random.default_rng(4).standard_normal((B, T, H, W, 3)).astype(np.float32)
    cfg = s2d_cfg(backbone, mode)
    jmodel, _ = jax_create(cfg)
    shapes = jax.eval_shape(lambda v: jmodel.init({"params": jax.random.key(0)}, v),
                            jnp.asarray(x))
    v = fill_variables(shapes, 6)
    stem = v["params"]["model"]["encoder"]["base_model"]["stem_0"]
    assert stem["spatial"]["conv"]["kernel"].shape == (1, 4, 4, 12, 64)
    assert stem["temporal"]["conv"]["kernel"].shape == (
        (4, 1, 1, 128, 64) if mode == "full" else (7, 1, 1, 64, 64))
    want = jax.jit(lambda vv, xx: jmodel.apply(vv, xx))(v, jnp.asarray(x))

    model, _ = create_visual_model(cfg)
    assert isinstance(model.model.encoder.base_model.base[0], layers.SepConvS2D)
    jax_weights.load_pretrain_weights(model, v["params"], v["batch_stats"], backbone)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert rel_l2(got.numpy(), np.asarray(want)) < 1e-5


@pytest.mark.parametrize("what", ["downstream", "cmc"])
@pytest.mark.parametrize("mode", MODES)
def test_folded_downstream_and_cmc_trees_load_strictly(what, mode):
    """JAX's downstream ``VideoModel`` and CMC trees with a folded stem go
    through the weight bridge into the port's models (strict names and
    shapes), the stems of both CMC stacks included."""
    from video_graph_ssl_tpu.models import create_video_model as jax_video
    from video_graph_ssl_tpu_torch.models.build import create_video_model

    cfg = s2d_cfg("S3DG", mode)
    cfg.DATASET.NUM_CLASS = 5
    if what == "cmc":
        cfg.CROSS.MODALITY = "cross"
    jmodel, _ = (jax_video if what == "downstream" else jax_create)(cfg)
    x = jnp.zeros((B, T, H, W, 3), jnp.float32)
    v = fill_variables(jax.eval_shape(
        lambda vv: jmodel.init({"params": jax.random.key(0)}, vv), x), 9)
    if what == "downstream":
        model, _ = create_video_model(cfg)
        jax_weights.load_downstream_weights(model, v["params"], v["batch_stats"])
        stems = [model.base_model.base[0]]
        roots = [v["params"]["encoder"]["base_model"]]
    else:
        model, _ = create_visual_model(cfg)
        jax_weights.load_pretrain_weights(model, v["params"], v["batch_stats"])
        stems = [getattr(model, s).model.encoder.base_model.base[0]
                 for s in ("model_1", "model_2")]
        roots = [v["params"][s]["encoder"]["base_model"] for s in ("model_1", "model_2")]
    for stem, root in zip(stems, roots):
        assert isinstance(stem, layers.SepConvS2D) and stem.temporal_bias
        want = np.asarray(root["stem_0"]["spatial"]["conv"]["kernel"]).transpose(4, 3, 0, 1, 2)
        assert np.array_equal(stem.conv_s.weight.detach().numpy(), want)


def _reference_s3d_sd(seed=7):
    """A reference-named S3D state_dict (the port's standard S3D's names)."""
    c = s2d_cfg("S3D", "off")
    c.MODEL.AUG_FLAG = False
    model, _ = create_visual_model(c, seed=seed)
    pre = "model.encoder.base_model."
    return {k[len(pre):]: v for k, v in model.state_dict().items() if k.startswith(pre)}


@pytest.mark.parametrize("mode", [True, "full", "spatial"])
def test_port_encoder_folds_like_convert_torch_s3d(mode):
    sd = _reference_s3d_sd()
    params, stats = convert_torch_s3d({k: v.numpy() for k, v in sd.items()}, stem_s2d=mode)
    want = jax_weights.s3d_state_dict(params, stats)
    got = port_encoder(sd, "S3D", stem_s2d=mode)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k
    # a folded stem has no reference names
    with pytest.raises(ValueError, match="space-to-depth"):
        reference_encoder(got, "S3D")
    with pytest.raises(ValueError, match="S3D/S3DG"):
        port_encoder(sd, "I3D", stem_s2d=mode)


def test_stem_params_to_s2d_matches_jax_on_a_wrapper_tree():
    """Every stem conv of a wrapper tree, under a graph wrap too; BN and
    bias entries as they were."""
    sd = {"model.encoder.base_model." + k: v for k, v in _reference_s3d_sd().items()}
    sd["model.encoder.base_model.base.0.conv_s.bias"] = torch.ones(64)
    wrapped = {k.replace("base.0.", "base.0.1."): v for k, v in sd.items()}
    for tree in (sd, wrapped):
        out = stem_params_to_s2d(tree, "full")
        changed = sorted(k for k in tree if not torch.equal(out[k], tree[k]))
        assert len(changed) == 2 and all(k.endswith(("conv_s.weight", "conv_t.weight"))
                                         for k in changed)
        w = tree[changed[0]].permute(2, 3, 4, 1, 0).numpy()
        jfold = jax_stem_to_s2d({"stem_0": {"spatial": {"conv": {"kernel": w}}}}, "spatial")
        assert np.array_equal(out[changed[0]].numpy(), np.asarray(
            jfold["stem_0"]["spatial"]["conv"]["kernel"]).transpose(4, 3, 0, 1, 2))


def _step(cfg, x):
    model, _ = create_visual_model(cfg, seed=0)
    model.train()
    out = model(torch.from_numpy(x))
    out.square().sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}, \
        {n: b.clone() for n, b in model.named_buffers()}


@pytest.mark.parametrize("mode", MODES)
def test_block_remat_step_with_s2d_stem_equals_no_remat(mode):
    x = np.random.default_rng(8).standard_normal((B, T, H, W, 3)).astype(np.float32)
    cfg = s2d_cfg("S3D", mode, "float64")
    base = _step(cfg, x)
    cfg.TPU.REMAT = True
    cfg.TPU.REMAT_POLICY = "block"
    got = _step(cfg, x)
    assert torch.equal(got[0], base[0])
    for a, b in zip(got[1:], base[1:]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
