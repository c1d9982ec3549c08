"""The port's S3DG, I3D and InceptionI3d backbones against the JAX package on
the CPU (B = 2, T = 8, 32x32: the smallest input at which the graph blocks
at stages 5 and 9 are legal; stage 14 gets 1x1 there, so it carries none).

* Eval features of S3DG (``S3D(temporal_bias=True)``) and I3D + graph,
  JAX variables carried through ``utils/jax_weights.py`` (strict), within
  1e-5 in fp32.
* Train mode in float64, graph block at 5 (see ``test_torch_models.py``
  for why the train-mode comparisons run in float64 with one block): the
  output, every parameter gradient (the stem conv, the Mixed branches and
  the graph block among them) and the BN running statistics within 1e-4.
  JAX's I3D pins its BatchNorm to fp32 (``Unit3D``: ``dtype=jnp.float32``,
  so flax computes the batch statistics in fp32 with its fast variance
  even in a float64 run), which in train mode at these few values per
  channel moves the output by 6e-3 (rel-L2) from the float64 function.
  The float64 comparisons lift that pin for the duration of the JAX call
  (:func:`jax_bn_follows_input`: flax's BatchNorm with its ``dtype`` left
  to its input; no JAX file changes), so both sides compute the same
  function in float64.  In bf16 and fp32 runs the pin and the port's BN
  round the same way: normalise in fp32, cast to the compute dtype.
* I3D under partial BN: one downstream step (``make_downstream_train_step``)
  against JAX's on ``create_video_model``, fp32, loss and every parameter
  and statistic within 1e-4 (partial BN leaves the deep stages affine).
* One GCA MoCo step with the I3D backbone in lockstep with JAX (float64,
  the pin lifted, B = 4): loss, every parameter, the EMA encoder and the
  queue within 1e-4.
* The reference's names (``utils/torch_names.py``): a reference-named S3DG
  and I3D state_dict, JAX's shape manifests filled with seeded values,
  through JAX's ``convert_torch_s3dg`` / ``convert_torch_i3d`` and through
  the port's name map give the same features; such a file loads strictly
  through ``MODEL.PRETRAIN_PATH`` into the pretrain trainer (both encoders)
  and into ``train_ds``.
* The registry: all three names build both models; ``InceptionI3d`` is
  I3D's network under I3D's names; ``TPU.SEPCONV_FUSED`` raises for them.
* ``kernel_times``' I3D tables (K2's inputs at the aug points, every pool's
  input, its "SAME" pads and its output) against the shapes of the JAX
  I3D's ``jax.eval_shape`` at 112x112 and 224x224.
"""

import contextlib
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import fill_variables, np_tree, rel_l2
from video_graph_ssl_tpu.config import cfg as jax_cfg
from video_graph_ssl_tpu.engine import create_downstream_state as jax_ds_state
from video_graph_ssl_tpu.engine import create_pretrain_state as jax_state
from video_graph_ssl_tpu.engine import make_pretrain_step
from video_graph_ssl_tpu.engine.downstream import make_downstream_train_step as jax_ds_step
from video_graph_ssl_tpu.models import create_video_model as jax_create_video
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu.models import i3d as jax_i3d
from video_graph_ssl_tpu.models.s3d import S3D as JaxS3D
from video_graph_ssl_tpu.utils import torch_interop
from video_graph_ssl_tpu_torch import train_ds
from video_graph_ssl_tpu_torch import train_video_contrast_dis as train
from video_graph_ssl_tpu_torch.engine.build import create_downstream_state, create_pretrain_state
from video_graph_ssl_tpu_torch.engine.downstream import make_downstream_train_step
from video_graph_ssl_tpu_torch.engine.pretrain import make_moco_step
from video_graph_ssl_tpu_torch.kernel_times import geometry
from video_graph_ssl_tpu_torch.models.build import create_video_model, create_visual_model
from video_graph_ssl_tpu_torch.models.i3d import I3D
from video_graph_ssl_tpu_torch.models.s3d import S3D
from video_graph_ssl_tpu_torch.ops import maxpool
from video_graph_ssl_tpu_torch.utils.jax_weights import (backbone_of, downstream_state_dict,
                                                         load_downstream_weights,
                                                         load_pretrain_weights,
                                                         pretrain_state_dict)
from video_graph_ssl_tpu_torch.utils.torch_names import (port_backbone_names,
                                                          reference_backbone_names)

torch.set_num_threads(1)
B, T, H, W = 2, 8, 32, 32
TOL = 1e-4
BACKBONES = ("S3DG", "I3D")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _LinenBnFollowsInput:
    """flax.linen with BatchNorm's ``dtype`` left to its input."""

    def __getattr__(self, name):
        return getattr(flax.linen, name)

    @staticmethod
    def BatchNorm(*args, dtype=None, **kw):
        return flax.linen.BatchNorm(*args, **kw)


@contextlib.contextmanager
def jax_bn_follows_input():
    """The JAX I3D's BatchNorm with its fp32 pin lifted (see the module
    docstring), while the context is open."""
    old = jax_i3d.nn
    jax_i3d.nn = _LinenBnFollowsInput()
    try:
        yield
    finally:
        jax_i3d.nn = old


def bb_cfg(backbone, dtype="float32", aug=(5, 9), mem_type="moco"):
    c = jax_cfg.clone()
    c.MODEL.BACKBONE = backbone
    c.MODEL.BACKBONE_TYPE = "3D"
    c.MODEL.AUG_FLAG = bool(aug)
    c.MODEL.DROPOUT = 0.0
    c.GRAPH.AUG_POINTS = tuple(aug)
    c.GRAPH.SAMPLER = "none"
    c.CONTRAST.MEM_TYPE = mem_type
    c.CROSS.FEAT_DIM = 128
    c.TPU.COMPUTE_DTYPE = dtype
    c.TPU.PACK_POINTWISE = False     # the same math; keeps float64 runs float64
    return c


def setup(backbone, aug=(5, 9), seed=0):
    """(clips, cotangent, params, batch_stats) of a JAX GraphWrapper."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((B, T, H, W, 3)).astype(np.float32)
    gout = g.standard_normal((B, 128)).astype(np.float32)
    model, _ = jax_create(bb_cfg(backbone, aug=aug))
    shapes = jax.eval_shape(lambda v: model.init({"params": jax.random.key(0)}, v),
                            jnp.asarray(x))
    v = fill_variables(shapes, seed + 1)
    return x, gout, v["params"], v["batch_stats"]


def port_model(backbone, dtype, params, stats, aug=(5, 9)):
    model, _ = create_visual_model(bb_cfg(backbone, dtype, aug))
    load_pretrain_weights(model, params, stats)        # strict
    return model


@pytest.mark.parametrize("backbone", BACKBONES)
def test_eval_features_match_jax(backbone):
    x, _, params, stats = setup(backbone)
    assert backbone_of(params["model"]["encoder"]["base_model"]) == backbone
    jmodel, _ = jax_create(bb_cfg(backbone))
    feat_ref, proj_ref = jax.jit(lambda v, xx: (jmodel.apply(v, xx, method=jmodel.encode),
                                               jmodel.apply(v, xx)))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    model = port_model(backbone, "float32", params, stats).eval()
    with torch.no_grad():
        feat, proj = model.encode(torch.from_numpy(x)), model(torch.from_numpy(x))
    assert feat.shape == (B, 1024) and proj.shape == (B, 128)
    assert rel_l2(feat.numpy(), feat_ref) < 1e-5
    assert rel_l2(proj.numpy(), proj_ref) < 1e-5


@pytest.mark.parametrize("backbone", BACKBONES)
def test_train_forward_grads_and_bn_stats_match_jax(backbone):
    aug = (5,)
    x, gout, params, stats = setup(backbone, aug)
    with jax.enable_x64(), jax_bn_follows_input():
        jmodel, _ = jax_create(bb_cfg(backbone, "float64", aug))

        def loss(p, xx):
            out, muts = jmodel.apply({"params": p, "batch_stats": stats}, xx, train=True,
                                     rngs={"graph": jax.random.key(1),
                                           "dropout": jax.random.key(2)},
                                     mutable=["batch_stats"])
            return jnp.sum(out * gout), (out, muts["batch_stats"])

        (_, (out_ref, new_stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params, jnp.asarray(x, jnp.float64))
        out_ref, grads, new_stats = np.asarray(out_ref), np_tree(grads), np_tree(new_stats)
    model = port_model(backbone, "float64", params, stats, aug).train()
    out = model(torch.from_numpy(x).double())
    (out * torch.from_numpy(gout)).sum().backward()
    assert rel_l2(out.detach().numpy(), out_ref) < TOL

    ref = pretrain_state_dict(grads, stats)
    named = dict(model.named_parameters())
    assert len(named) == len([k for k in ref if "running" not in k])
    enc = "model.encoder.base_model.base."
    stem = enc + ("0.conv_s.weight" if backbone == "S3DG" else "0.conv.weight")
    for name in (stem, enc + "5.0.g_q.0.weight", enc + "5.0.gcns.0.conv.weight",
                 enc + "8.branch1.1." + ("conv_t.weight" if backbone == "S3DG"
                                         else "conv.weight")):
        assert name in named, name
    if backbone == "S3DG":
        assert enc + "3.conv_t.bias" in named
    # a gradient below 1e-9 of the largest one is cancellation noise in
    # both packages; it is held to that floor (test_torch_models_grads.py)
    floor = 1e-9 * max(np.linalg.norm(ref[n]) for n in named)
    for name, p in named.items():
        diff = np.linalg.norm(p.grad.numpy().astype(np.float64) - ref[name])
        assert diff < TOL * max(np.linalg.norm(ref[name]), floor), name
    ref_sd = pretrain_state_dict(params, new_stats)
    bufs = dict(model.named_buffers())
    assert len(bufs) == len([k for k in ref_sd if "running" in k])
    for name, buf in bufs.items():
        assert rel_l2(buf.numpy(), ref_sd[name]) < TOL, name


def test_i3d_partial_bn_downstream_step_matches_jax():
    c = bb_cfg("I3D", aug=(5, 9))
    c.DATASET.NUM_CLASS = 8
    c.MODEL.NO_PARTIALBN = False
    g = np.random.default_rng(4)
    clips = g.standard_normal((B, T, H, W, 3)).astype(np.float32)
    labels = g.integers(0, 8, B).astype(np.int32)
    jmodel, _ = jax_create_video(c)
    state, tx = jax_ds_state(c, jmodel, jnp.asarray(clips))
    model, _ = create_video_model(c)
    load_downstream_weights(model, np_tree(state.params), np_tree(state.batch_stats))
    tstate = create_downstream_state(c, model, "cpu")
    before = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    state, jm = jax.jit(jax_ds_step(jmodel, tx, True))(
        state, {"clips": jnp.asarray(clips), "label": jnp.asarray(labels)}, 0.1)
    tm = make_downstream_train_step(True)(tstate, torch.from_numpy(clips),
                                          torch.from_numpy(labels), 0.1)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
    ref = downstream_state_dict(np_tree(state.params), np_tree(state.batch_stats))
    ours = {k: v.detach().numpy() for k, v in tstate.model.state_dict().items()}
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert rel_l2(ours[k], ref[k]) < TOL, k
    # partial BN: conv3d_1a's statistics move, no other backbone BN's
    moved = sorted(k for k, v in before.items() if "running" in k
                   and not torch.equal(v, tstate.model.state_dict()[k]))
    assert moved == ["base_model.base.0.bn.running_mean", "base_model.base.0.bn.running_var"]


def test_i3d_moco_step_lockstep_with_jax():
    b, aug = 4, (5,)
    c = bb_cfg("I3D", "float64", aug)
    c.CROSS.FEAT_DIM = 32
    c.CONTRAST.NCE_K = 16
    clips = np.random.default_rng(0).standard_normal((b, 2, T, H, W, 3)).astype(np.float32)
    with jax.enable_x64(), jax_bn_follows_input():
        jmodel, _ = jax_create(c)
        state, tx = jax_state(c, jmodel, jnp.asarray(clips[:2, 0]), n_data=32)
        model, _ = create_visual_model(c)
        load_pretrain_weights(model, np_tree(state.params), np_tree(state.batch_stats))
        tstate = create_pretrain_state(c, model, "cpu")
        tstate.contrast.queue.copy_(torch.from_numpy(np.array(state.contrast.queue, np.float32)))
        batch = {"clips": jnp.asarray(clips, jnp.float64), "label": jnp.zeros((b,), jnp.int32),
                 "index": jnp.arange(b, dtype=jnp.int32)}
        state, jm = jax.jit(make_pretrain_step(c, jmodel, tx))(state, batch, 0.1)
        jloss = float(jm["loss"])
        refs = {"model": pretrain_state_dict(np_tree(state.params), np_tree(state.batch_stats)),
                "ema": pretrain_state_dict(np_tree(state.ema_params),
                                           np_tree(state.ema_batch_stats))}
    tm = make_moco_step(float(c.CONTRAST.NCE_T), float(c.CONTRAST.ALPHA))(
        tstate, torch.from_numpy(clips).double(), 0.1)
    assert np.isfinite(jloss)
    assert abs(float(tm["loss"]) - jloss) <= TOL * abs(jloss)
    assert tstate.contrast.ptr == int(state.contrast.ptr) == b
    assert rel_l2(tstate.contrast.queue.numpy(), state.contrast.queue) < TOL
    for name, port in (("model", tstate.model), ("ema", tstate.ema_model)):
        ours = {k: v.detach().double().numpy() for k, v in port.state_dict().items()}
        ref = refs[name]
        assert sorted(ours) == sorted(ref)
        # a tensor below 1e-9 of the largest is zero in exact arithmetic
        # (a BN bias whose update cancels): held to that floor
        floor = 1e-9 * max(np.linalg.norm(v) for v in ref.values())
        for k in ref:
            diff = np.linalg.norm(ours[k] - ref[k])
            assert diff < TOL * max(np.linalg.norm(ref[k]), floor), f"{name}: {k}"
    # the EMA moved, and by less than the params
    head = "model.proj_head.head.0.weight"
    assert not np.array_equal(refs["ema"][head], refs["model"][head])


# --------------------------------------------------------------------------- #
# the reference's names
# --------------------------------------------------------------------------- #
REFERENCE = {"S3DG": (torch_interop.reference_s3dg_shape_manifest,
                      torch_interop.convert_torch_s3dg),
             "I3D": (torch_interop.reference_i3d_shape_manifest,
                     torch_interop.convert_torch_i3d)}


def reference_state_dict(backbone, seed=7):
    """A reference-named backbone state_dict (JAX's shape manifest, with a
    classifier) filled with seeded values."""
    g = np.random.default_rng(seed)
    sd = {}
    for name, shape in REFERENCE[backbone][0](num_classes=10).items():
        if name.endswith("running_var") or (name.endswith(".weight") and len(shape) == 1):
            v = g.uniform(0.5, 1.5, shape)
        elif len(shape) == 5:
            v = g.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            v = 0.05 * g.standard_normal(shape)
        sd[name] = v.astype(np.float32)
    return sd


@pytest.mark.parametrize("backbone", BACKBONES)
def test_reference_names_give_jax_features(backbone):
    sd = reference_state_dict(backbone)
    params, stats = REFERENCE[backbone][1](sd)
    jmodel = (jax_i3d.I3D(dtype=jnp.float32) if backbone == "I3D"
              else JaxS3D(temporal_bias=True, dtype=jnp.float32))
    x = np.random.default_rng(8).standard_normal((B, T, H, W, 3)).astype(np.float32)
    ref = jax.jit(jmodel.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x))
    port = (I3D(dtype=torch.float32) if backbone == "I3D"
            else S3D(temporal_bias=True, dtype=torch.float32)).eval()
    named = port_backbone_names({k: torch.from_numpy(v) for k, v in sd.items()})
    assert len(named) == len(sd) - 2      # the classifier's weight and bias
    port.load_state_dict(named, strict=True)
    with torch.no_grad():
        feat = port(torch.from_numpy(x))
    assert rel_l2(feat.numpy(), ref) < 1e-5


@pytest.mark.parametrize("backbone,layout", [("S3DG", "s3dg"), ("I3D", "i3d")])
def test_name_maps_are_the_manifests_both_ways(backbone, layout):
    """The port's backbone names through ``reference_backbone_names`` are
    JAX's manifest, shapes included, and map back to themselves."""
    own = (I3D() if backbone == "I3D" else S3D(temporal_bias=True)).state_dict()
    ref = reference_backbone_names(own, layout)
    manifest = REFERENCE[backbone][0]()
    assert sorted(ref) == sorted(manifest)
    for k, shape in manifest.items():
        assert tuple(ref[k].shape) == tuple(shape), k
    back = port_backbone_names(ref)
    assert sorted(back) == sorted(own) and all(back[k] is v for k, v in own.items())


TINY = ["MODEL.AUG_FLAG", "False", "DATASET.SOURCE", "synthetic", "DATASET.NUM_CLASS", "4",
        "DATALOADER.BATCH_SIZE", "2", "DATALOADER.NUM_WORKERS", "1", "TEST.BATCH_SIZE", "2",
        "INPUT.VIDEO_LENGTH", "8", "INPUT.SCALE_SIZE", "[36, 36]", "INPUT.BASE_SIZE",
        "[32, 32]", "INPUT.CROP_SIZE", "[32, 32]", "CONTRAST.NCE_K", "8", "CROSS.FEAT_DIM",
        "16", "TPU.COMPUTE_DTYPE", "float32", "CHECKPOINT.PRINT_FREQ", "1"]


@pytest.mark.parametrize("backbone", BACKBONES)
def test_reference_state_dict_loads_through_pretrain_path(backbone, tmp_path):
    """The reference-named file (wrapped as the reference saves it) warm-
    starts the pretrain trainer's two encoders and train_ds's backbone,
    strictly; both then take a step."""
    sd = {f"module.{k}": torch.from_numpy(v) for k, v in reference_state_dict(backbone).items()}
    sd.update({k.rsplit(".", 1)[0] + ".num_batches_tracked": torch.tensor(5)
               for k in sd if k.endswith("running_mean")})
    path = str(tmp_path / "reference.pth")
    torch.save({"state_dict": sd}, path)
    want = port_backbone_names({k[len("module."):]: v for k, v in sd.items()})
    opts = TINY + ["MODEL.BACKBONE", backbone, "MODEL.PRETRAINED", "True",
                   "MODEL.PRETRAIN_PATH", path]
    trainer = train.Trainer(train.load_config(os.path.join(REPO, "configs", "visual_moco.yaml"),
                                              opts),
                            max_steps=1, device="cpu", run_dir=str(tmp_path / "run"))
    for model in (trainer.state.model, trainer.state.ema_model):
        got = model.model.encoder.base_model.state_dict()
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    trainer.train(0)
    ds = train_ds.Trainer(train.load_config(os.path.join(REPO, "configs", "smoke_ds.yaml"),
                                            opts), max_steps=1, device="cpu",
                          run_dir=str(tmp_path / "ds"))
    got = ds.state.model.base_model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    ds.training(0)
    assert all(np.isfinite(p.detach().numpy()).all() for p in ds.state.model.parameters())


# --------------------------------------------------------------------------- #
# the registry and kernel_times' tables
# --------------------------------------------------------------------------- #
def test_registry_builds_the_three_backbones():
    names = {}
    for name in ("S3DG", "I3D", "InceptionI3d"):
        c = bb_cfg(name, aug=(5, 9, 14))
        c.DATASET.NUM_CLASS = 8
        model, dim = create_visual_model(c)
        video, vdim = create_video_model(c)
        assert dim == vdim == 1024
        base = model.model.encoder.base_model
        assert base.aug_points == (5, 9, 14)
        names[name] = sorted(base.state_dict())
        with pytest.raises(ValueError, match="SEPCONV_FUSED"):
            c.TPU.SEPCONV_FUSED = True
            create_visual_model(c)
    assert names["InceptionI3d"] == names["I3D"]
    assert any(n.endswith("conv_t.bias") for n in names["S3DG"])
    assert not any(n.endswith(".bias") and "conv" in n for n in names["I3D"])
    # S3DG's temporal kernels start Normal(0, 0.01)
    model, _ = create_visual_model(bb_cfg("S3DG", aug=()))
    wt = model.model.encoder.base_model.base[8].branch1[1].conv_t.weight
    assert abs(float(wt.detach().std()) - 0.01) < 1e-3
    with pytest.raises(NotImplementedError, match="item 6b"):
        create_visual_model(bb_cfg("resnet50", aug=()))


def _jax_i3d_shapes(size, batch):
    """(K2's inputs at 5, 9, 14; every pool's input and output extents, in
    kernel_times' order) from the JAX I3D's ``eval_shape`` with its
    modules' outputs captured: a Mixed block's input is its branch0's
    extent (a 1x1x1 conv) with the previous stage's channels."""
    model = jax_i3d.I3D(dtype=jnp.bfloat16)
    x = jax.ShapeDtypeStruct((batch, 16, size, size, 3), jnp.float32)
    variables = jax.eval_shape(lambda v: model.init({"params": jax.random.key(0)}, v), x)
    _, inter = jax.eval_shape(lambda v, xx: model.apply(
        v, xx, capture_intermediates=True, mutable=["intermediates"]), variables, x)
    inter = inter["intermediates"]

    def out(*path):
        node = inter
        for name in path:
            node = node[name]
        return tuple(node["__call__"][0].shape)

    mixed = ["mixed_3b", "mixed_3c", "mixed_4b", "mixed_4c", "mixed_4d", "mixed_4e",
             "mixed_4f", "mixed_5b", "mixed_5c"]
    ins = {m: out(m, "branch0")[:4] + (out(prev)[4],)
           for m, prev in zip(mixed, ["conv3d_2c"] + mixed)}
    k2 = [ins["mixed_3b"], ins["mixed_4c"], ins["mixed_5b"]]
    pools = [(out("conv3d_1a"), out("conv3d_2b")), (out("conv3d_2c"), ins["mixed_3b"]),
             (out("mixed_3c"), ins["mixed_4b"]), (out("mixed_4f"), ins["mixed_5b"])]
    pools += [(ins[m], ins[m]) for m in mixed]
    return k2, pools


@pytest.mark.parametrize("size,batch", [(112, 128), (224, 32)])
def test_kernel_times_i3d_tables_match_jax(size, batch):
    k1, k2, pools, seps = geometry(size, batch, "I3D")
    k2_ref, pools_ref = _jax_i3d_shapes(size, batch)
    assert [tuple(s) for s in k2] == k2_ref
    assert seps == []
    assert [r[1] for r in pools] == ["K4"] * 4 + ["K3"] * 9
    for (name, kn, shape, k, s, p), (x_ref, y_ref) in zip(pools, pools_ref):
        assert shape == x_ref, name
        assert p == maxpool.same_padding(shape[1:4], k, s), name
        assert maxpool.out_sizes(shape[1:4], k, s, p) == y_ref[1:4], name
    if size == 112:     # the 4x4 of stage 13 (S3D: 3x3) and its graph block
        assert k2[2] == (128, 2, 4, 4, 832) and k1[2] == (128, 2, 1664)
        assert pools[3][5] == ((0, 0), (0, 1), (0, 1))
