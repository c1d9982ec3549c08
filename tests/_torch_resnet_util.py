"""Shared helpers of the parity tests of the port's ResNet and 2D Inception
backbones against the JAX package (tests/test_torch_backbones_*.py).

Inputs and values come from numpy with a seed; the JAX model's variables
are filled from its ``jax.eval_shape`` (``_torch_port_util.fill_variables``)
and carried into the port through ``utils/jax_weights.py`` (strict).

Every JAX backbone here pins its BatchNorm to fp32 (``dtype=jnp.float32``),
so in a float64 run flax computes the batch statistics in fp32.  The
float64 comparisons lift that pin while the JAX call runs
(:func:`jax_bn_follows_input`: flax's BatchNorm with its ``dtype`` left to
its input; no JAX file changes), so both sides compute the same function
in float64; in bf16 and fp32 runs the pin and the port's BN round alike.

The graph blocks' relaxed-Bernoulli noise is JAX's: :func:`capture_jax_noise`
records each draw by its frame count T (the three ResNet aug points see T/2,
T/4 and T/8 frames), :func:`inject_noise` hands the port's graph block of T
frames that draw.  Where the blocks share T (``i3d_res50_nonlocal``: T = 2
at all three) the draws are keyed by the JAX block's name instead
(``blocks``), and the port's blocks, called in stage order, take them in
that order.
"""

import contextlib
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_util import fill_variables, np_tree, rel_l2
from video_graph_ssl_tpu.config import cfg as jax_cfg
from video_graph_ssl_tpu.engine import create_downstream_state as jax_ds_state
from video_graph_ssl_tpu.engine import create_pretrain_state as jax_state
from video_graph_ssl_tpu.engine import make_pretrain_step
from video_graph_ssl_tpu.engine.downstream import make_downstream_train_step as jax_ds_step
from video_graph_ssl_tpu.models import bninception as jax_bninception
from video_graph_ssl_tpu.models import i3dnon as jax_i3dnon
from video_graph_ssl_tpu.models import create_video_model as jax_create_video
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu.models import inceptionv3 as jax_inceptionv3
from video_graph_ssl_tpu.models import resnet2d as jax_resnet2d
from video_graph_ssl_tpu.models import resnet2p1d as jax_resnet2p1d
from video_graph_ssl_tpu.models import resnet3d as jax_resnet3d
from video_graph_ssl_tpu.models import s3dg_text as jax_s3dg_text
from video_graph_ssl_tpu.ops import temporal_graph as jtg
from video_graph_ssl_tpu_torch.engine.build import create_downstream_state, create_pretrain_state
from video_graph_ssl_tpu_torch.engine.downstream import make_downstream_train_step
from video_graph_ssl_tpu_torch.engine.pretrain import make_moco_step
from video_graph_ssl_tpu_torch.models.build import create_video_model, create_visual_model
from video_graph_ssl_tpu_torch.ops import temporal_graph as ttg
from video_graph_ssl_tpu_torch.utils.jax_weights import (backbone_of, downstream_state_dict,
                                                         load_downstream_weights,
                                                         load_pretrain_weights,
                                                         pretrain_state_dict)

torch.set_num_threads(1)
TOL = 1e-4
JAX_MODULES = (jax_resnet2d, jax_resnet3d, jax_resnet2p1d, jax_bninception, jax_inceptionv3,
               jax_i3dnon, jax_s3dg_text)


class _LinenBnFollowsInput:
    """flax.linen with BatchNorm's ``dtype`` left to its input."""

    def __getattr__(self, name):
        return getattr(flax.linen, name)

    @staticmethod
    def BatchNorm(*args, dtype=None, **kw):
        return flax.linen.BatchNorm(*args, **kw)


@contextlib.contextmanager
def jax_bn_follows_input():
    """The JAX backbones' BatchNorm with its fp32 pin lifted while the
    context is open."""
    old = [m.nn for m in JAX_MODULES]
    for m in JAX_MODULES:
        m.nn = _LinenBnFollowsInput()
    try:
        yield
    finally:
        for m, nn in zip(JAX_MODULES, old):
            m.nn = nn


def make_cfg(backbone, btype="3D", dtype="float32", aug=(), mem_type="moco",
             sampler="none", pooling="avg"):
    c = jax_cfg.clone()
    c.MODEL.BACKBONE = backbone
    c.MODEL.BACKBONE_TYPE = btype
    c.MODEL.AUG_FLAG = bool(aug)
    c.MODEL.DROPOUT = 0.0
    c.MODEL.POOLING_TYPE = pooling
    c.GRAPH.AUG_POINTS = tuple(aug)
    c.GRAPH.SAMPLER = sampler
    c.CONTRAST.MEM_TYPE = mem_type
    c.CROSS.FEAT_DIM = 128
    c.TPU.COMPUTE_DTYPE = dtype
    c.TPU.PACK_POINTWISE = False
    return c


# the graph blocks' q/k embedding kernels are drawn at this scale of
# fill_variables' N(0, 1/fan_in) (see setup)
EMBED_SCALE = 0.03


def setup(c, shape, seed=0):
    """(clips, cotangent, params, batch_stats) of the JAX GraphWrapper of
    ``c`` on clips of ``shape``.

    The graph blocks' q/k kernels are scaled by EMBED_SCALE.  At full scale
    (and at JAX's fan-in uniform init) a block's similarities on these
    inputs reach 200-5000, so its row softmax is saturated: entries are 0
    or within fp32 rounding of 1, where ``logit(clip(p))`` is
    ill-conditioned (1 - p resolved to 6e-8), and the q/k gradients are
    set by the last fp32 bit in which the packages' softmaxes differ (7e-3
    apart at resnet3d_10's stage 3).  Scaled, the similarities are O(1)
    and every gradient path through the softmax is live and well
    conditioned."""
    g = np.random.default_rng(seed)
    x = g.standard_normal(shape).astype(np.float32)
    gout = g.standard_normal((shape[0], 128)).astype(np.float32)
    model, _ = jax_create(c)
    shapes = jax.eval_shape(lambda v: model.init({"params": jax.random.key(0)}, v),
                            jnp.asarray(x))
    v = fill_variables(shapes, seed + 1)
    return x, gout, scale_embeds(v["params"]), v["batch_stats"]


def scale_embeds(params):
    """``params`` with every graph block's q/k kernel times EMBED_SCALE."""
    def scale(path, leaf):
        keys = [str(getattr(k, "key", k)) for k in path]
        embed = any(k in ("g_q", "g_k") for k in keys) and keys[-1] == "kernel"
        return leaf * EMBED_SCALE if embed else leaf
    return jax.tree_util.tree_map_with_path(scale, params)


def port_model(c, params, stats):
    model, _ = create_visual_model(c)
    load_pretrain_weights(model, params, stats)        # strict
    return model


def capture_jax_noise(monkeypatch, by_block: bool = False) -> dict:
    """Record every relaxed-Bernoulli uniform draw of the JAX graph blocks,
    keyed by the block's frame count (or, ``by_block``, its name)."""
    drawn = {}
    orig = jtg.relaxed_bernoulli_sample

    def record(tag, u):
        drawn[u.shape[1] if tag is None else tag] = np.array(u)

    def capture(key, probs, temperature, eps=1e-6):
        u = jax.random.uniform(key, probs.shape, jnp.float32, minval=eps, maxval=1.0 - eps)
        tag = flax.linen.module._context.module_stack[-1].name if by_block else None
        jax.debug.callback(functools.partial(record, tag), u)
        return orig(key, probs, temperature, eps)

    monkeypatch.setattr(jtg, "relaxed_bernoulli_sample", capture)
    return drawn


def inject_noise(monkeypatch, drawn: dict, blocks=None) -> list:
    """The port's graph block of T frames takes JAX's draw of T frames, or
    with ``blocks`` (JAX block names in stage order) the n-th sampling call
    takes the draw of ``blocks[n % len(blocks)]``; returns the keys of the
    sampling calls, in order."""
    seen = []
    orig = ttg.graph_adjacency

    def inject(q, k, theta, seed=0, sample=False, u=None, **kw):
        if sample:
            seen.append(blocks[len(seen) % len(blocks)] if blocks else q.shape[1])
            u = torch.from_numpy(drawn[seen[-1]]).to(q.device)
        return orig(q, k, theta, seed=seed, sample=sample, u=u, **kw)

    monkeypatch.setattr(ttg, "graph_adjacency", inject)
    return seen


def eval_parity(c, shape):
    """Eval features and projections of the JAX and port models (fp32)."""
    x, _, params, stats = setup(c, shape)
    jmodel, _ = jax_create(c)
    feat_ref, proj_ref = jax.jit(lambda v, xx: (jmodel.apply(v, xx, method=jmodel.encode),
                                               jmodel.apply(v, xx)))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    model = port_model(c, params, stats).eval()
    with torch.no_grad():
        feat, proj = model.encode(torch.from_numpy(x)), model(torch.from_numpy(x))
    return feat.numpy(), np.asarray(feat_ref), proj.numpy(), np.asarray(proj_ref), params


def _zero_grad(name: str, zero_grad) -> bool:
    return any(name.endswith(z) for z in zero_grad)


def train_parity(c, shape, monkeypatch, floor_rel=1e-9, blocks=None, zero_grad=()):
    """Train mode in float64 (the JAX BN pin lifted), JAX's graph noise
    injected (``blocks``: :func:`inject_noise`): asserts the output, every
    parameter gradient and every BN statistic within TOL; returns the port
    model.  A parameter named with a suffix in ``zero_grad`` has a zero
    gradient in exact arithmetic, and each package's is its own rounding:
    both are held below 1e-3 of the largest gradient instead."""
    x, gout, params, stats = setup(c, shape)
    drawn = capture_jax_noise(monkeypatch, by_block=blocks is not None)
    with jax.enable_x64(), jax_bn_follows_input():
        jmodel, _ = jax_create(c)

        def loss(p, xx):
            out, muts = jmodel.apply({"params": p, "batch_stats": stats}, xx, train=True,
                                     rngs={"graph": jax.random.key(1),
                                           "dropout": jax.random.key(2)},
                                     mutable=["batch_stats"])
            return jnp.sum(out * gout), (out, muts["batch_stats"])

        (_, (out_ref, new_stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params, jnp.asarray(x, jnp.float64))
        out_ref, grads, new_stats = np.asarray(out_ref), np_tree(grads), np_tree(new_stats)
    seen = inject_noise(monkeypatch, drawn, blocks)
    model = port_model(c, params, stats).train()
    out = model(torch.from_numpy(x).double())
    (out * torch.from_numpy(gout)).sum().backward()
    assert sorted(seen) == sorted(drawn), (seen, sorted(drawn))
    assert rel_l2(out.detach().numpy(), out_ref) < TOL

    ref = pretrain_state_dict(grads, stats)
    named = dict(model.named_parameters())
    assert len(named) == len([k for k in ref if "running" not in k])
    # a gradient below 1e-9 of the largest one is cancellation noise in
    # both packages; it is held to that floor (test_torch_models_grads.py)
    top = max(np.linalg.norm(ref[n]) for n in named)
    floor = floor_rel * top
    for name, p in named.items():
        if _zero_grad(name, zero_grad):
            assert max(float(p.grad.norm()), np.linalg.norm(ref[name])) < 1e-3 * top, name
            continue
        diff = np.linalg.norm(p.grad.numpy().astype(np.float64) - ref[name])
        assert diff < TOL * max(np.linalg.norm(ref[name]), floor), name
    ref_sd = pretrain_state_dict(params, new_stats)
    bufs = dict(model.named_buffers())
    assert len(bufs) == len([k for k in ref_sd if "running" in k])
    for name, buf in bufs.items():
        assert rel_l2(buf.numpy(), ref_sd[name]) < TOL, name
    return model


def downstream_lockstep(c, shape, seed=4):
    """One partial-BN fine-tune step of JAX's ``VideoModel`` and the port's
    from one state (fp32): loss, every parameter and statistic within TOL;
    returns the names of the BN statistics that moved."""
    g = np.random.default_rng(seed)
    clips = g.standard_normal(shape).astype(np.float32)
    labels = g.integers(0, int(c.DATASET.NUM_CLASS), shape[0]).astype(np.int32)
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
    return sorted(k for k, v in before.items() if "running" in k
                  and not torch.equal(v, tstate.model.state_dict()[k]))


def moco_lockstep(c, shape, monkeypatch, blocks=None, tweak=lambda p: p, zero_grad=()):
    """One GCA MoCo step of JAX's and the port's from one state in float64
    (the JAX BN pin lifted, JAX's graph noise injected (``blocks``:
    :func:`inject_noise`), the graph blocks' q/k kernels scaled as in
    :func:`setup`, then ``tweak`` applied to the params and the EMA params):
    loss, every parameter, the EMA encoder and the queue within TOL.  A
    parameter with a zero gradient in exact arithmetic (a suffix in
    ``zero_grad``, as in :func:`train_parity`) moves by its package's
    rounding alone: each package's move is held below 1e-3 of the largest
    move of any tensor instead."""
    clips = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    b = shape[0]
    drawn = capture_jax_noise(monkeypatch, by_block=blocks is not None)
    with jax.enable_x64(), jax_bn_follows_input():
        jmodel, _ = jax_create(c)
        state, tx = jax_state(c, jmodel, jnp.asarray(clips[:2, 0]), n_data=32)
        state = state.replace(params=tweak(scale_embeds(state.params)),
                              ema_params=tweak(scale_embeds(state.ema_params)))
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
    inject_noise(monkeypatch, drawn, blocks)
    before = {name: {k: v.detach().double().numpy().copy() for k, v in m.state_dict().items()}
              for name, m in (("model", tstate.model), ("ema", tstate.ema_model))}
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
        top = max(np.linalg.norm(ref[k] - before[name][k]) for k in ref)
        for k in ref:
            if _zero_grad(k, zero_grad):
                moves = [np.linalg.norm(v[k] - before[name][k]) for v in (ours, ref)]
                assert max(moves) < 1e-3 * top, f"{name}: {k}"
                continue
            diff = np.linalg.norm(ours[k] - ref[k])
            assert diff < TOL * max(np.linalg.norm(ref[k]), floor), f"{name}: {k}"
    return drawn


def reference_state_dict(manifest: dict, seed: int = 7) -> dict:
    """A reference-named state_dict (a JAX shape manifest) filled with
    seeded numpy values: BN scales and variances in [0.5, 1.5], conv
    kernels ~ N(0, 1/fan_in), the rest ~ N(0, 0.05)."""
    g = np.random.default_rng(seed)
    sd = {}
    for name, shape in manifest.items():
        if name.endswith("running_var") or (name.endswith(".weight") and len(shape) == 1):
            v = g.uniform(0.5, 1.5, shape)
        elif len(shape) >= 4:
            v = g.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        else:
            v = 0.05 * g.standard_normal(shape)
        sd[name] = v.astype(np.float32)
    return sd


def jax_converted(converter, sd: dict) -> dict:
    """A reference-named ``sd`` through JAX's converter, then the port's
    weight bridge: the port's backbone names and values."""
    params, stats = converter(sd)
    from video_graph_ssl_tpu_torch.utils.jax_weights import BACKBONES
    return BACKBONES[backbone_of(params)](params, stats)

