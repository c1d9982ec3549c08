"""The port's optimizers, the TSN 'trick' groups and the LR schedules
against the JAX package's optax chains on the CPU.

* Every optimizer (SGD, Adam, AdamW, LARS) with and without
  ``SOLVER.USE_TRICK``, with and without ``SOLVER.CLIP_GRADIENT``, on an
  RGB and a Flow (``NEW_LENGTH`` 1: a 2-channel stem, which the trick finds
  and gives Flow's learning-rate multipliers) tiny3d + graph block MoCo
  model: three steps from the same parameters and the same gradients,
  carried through the weight bridge, against JAX ``make_optimizer``; each
  parameter's update within 1e-6 (rel-L2) above the fp32 floor of reading
  an update off a parameter (``_assert_update``).
* The trick's labels of S3D, tiny3d, a 2D ResNet, a 3D ResNet, the
  SimSiam model and the downstream ``VideoModel`` equal JAX's
  ``label_params_trick``, parameter by parameter through the name maps.
* The linear probe under Adam and LARS: the frozen parameters end each step
  bit-identical and hold no optimizer state; ``new_fc``'s updates equal
  JAX's under its ``trainable_mask``.
* ``make_iter_lr_scheduler`` and ``build_lr_spaces`` against JAX's at every
  step and epoch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_util import np_tree, rel_l2
from _torch_resnet_util import setup
from video_graph_ssl_tpu.models import create_video_model as jax_video_model
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu.solver import build as jsb
from video_graph_ssl_tpu_torch.engine.build import is_probe_param
from video_graph_ssl_tpu_torch.models.build import create_video_model, create_visual_model
from video_graph_ssl_tpu_torch.solver import build as tsb
from video_graph_ssl_tpu_torch.utils.jax_weights import (downstream_state_dict,
                                                         load_downstream_weights,
                                                         load_pretrain_weights,
                                                         pretrain_state_dict)

torch.set_num_threads(1)
LRS = (0.1, 0.05, 0.02)
TOL = 1e-6


def _cfg(tiny_cfg, name="SGD", trick=False, clip=False, modality="RGB", backbone="tiny3d",
         btype="3D"):
    c = tiny_cfg.clone()
    c.MODEL.BACKBONE = backbone
    c.MODEL.BACKBONE_TYPE = btype
    c.MODEL.AUG_FLAG = btype == "3D"
    c.GRAPH.SAMPLER = "none"
    c.INPUT.MODALITY = modality
    c.INPUT.NEW_LENGTH = 1
    c.TPU.PACK_POINTWISE = False
    c.SOLVER.OPTIMIZER_NAME = name
    c.SOLVER.USE_TRICK = trick
    # 10: the gradients' global norm is about 155, so the clip acts; at 1
    # the clipped gradient is as large as the weight decay term, a few
    # elements' sums cancel to 1e-6 of their terms, and Adam's normalisation
    # turns the fp32 rounding of the norm into 1e-2 of those updates
    c.SOLVER.CLIP_GRADIENT = 10.0 if clip else "none"
    c.SOLVER.WEIGHT_DECAY = 5e-3
    c.SOLVER.WEIGHT_DECAY_BIAS = 1e-3
    c.SOLVER.BIAS_LR_FACTOR = 2.0
    c.SOLVER.MOMENTUM = 0.9
    return c


@functools.lru_cache(maxsize=None)
def _jax_params(modality, backbone="tiny3d", btype="3D", downstream=False):
    """The JAX model's (params, batch_stats) for the config, numpy leaves."""
    from video_graph_ssl_tpu.config import cfg as jax_cfg

    c = _cfg(jax_cfg, modality=modality, backbone=backbone, btype=btype)
    c.CROSS.FEAT_DIM = 32          # tests/conftest.py:tiny_cfg's
    c.DATASET.NUM_CLASS = 8
    c.INPUT.BASE_SIZE = [32, 32] if backbone != "tiny3d" else [16, 16]
    size = c.INPUT.BASE_SIZE[0]
    length = 8 if backbone != "tiny3d" else 4
    shape = (2, length, size, size, 2 if modality == "Flow" else 3)
    if downstream:
        jmodel, _ = jax_video_model(c)
        x = jnp.zeros(shape, jnp.float32)
        v = jax.jit(lambda k: jmodel.init({"params": k}, x))(jax.random.key(3))
        return np_tree(v["params"]), np_tree(v["batch_stats"])
    _, _, params, stats = setup(c, shape)
    return np_tree(params), np_tree(stats)


def _grads(params, seed):
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda p: g.standard_normal(p.shape).astype(np.float32),
                                  params)


def _jax_updates(c, params, grads_list, mask=None):
    """JAX's parameters after each of the steps (numpy trees)."""
    tx = jsb.make_optimizer(c, params, mask)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p)
    out = []
    for lr, grads in zip(LRS, grads_list):
        state = jsb.set_learning_rate(state, lr)
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, p)
        p = optax.apply_updates(p, upd)
        out.append(np_tree(p))
    return out


def _port_steps(c, model, grads_list, trainable=None):
    """The port's parameters after each step (state dicts of numpy)."""
    opt = tsb.make_optimizer(c, model, trainable)
    clip = tsb.grad_clip_norm(c)
    named = dict(model.named_parameters())
    out = []
    for lr, grads in zip(LRS, grads_list):
        for k, p in named.items():
            p.grad = torch.from_numpy(np.ascontiguousarray(grads[k])).clone()
        if clip is not None:
            tsb.clip_by_global_norm_(model.parameters(), clip)
        tsb.set_learning_rate(opt, lr)
        opt.step()
        out.append({k: v.detach().numpy().copy() for k, v in model.state_dict().items()})
    return opt, out


def _assert_update(ours, ref, init, where):
    """The parameter's update within TOL of JAX's update (L2) plus the fp32
    floor of reading an update off a parameter: p_new - p_0 carries the
    roundings of both fp32 values, 2^-22 |p| (a BN scale near 1 moved by
    0.1 has 1e-6 of such noise)."""
    u = ours.astype(np.float64) - init
    v = ref.astype(np.float64) - init
    diff = np.linalg.norm(u - v)
    assert diff <= TOL * np.linalg.norm(v) + 2.0 ** -22 * np.linalg.norm(ref), (
        where, diff / np.linalg.norm(v))


def _as_port(tree, stats, downstream=False):
    return (downstream_state_dict if downstream else pretrain_state_dict)(tree, stats)


@pytest.mark.parametrize("modality", ["RGB", "Flow"])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("trick", [False, True])
@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW", "LARS"])
def test_optimizer_matches_optax(tiny_cfg, name, trick, clip, modality):
    c = _cfg(tiny_cfg, name, trick, clip, modality)
    params, stats = _jax_params(modality)
    grads_jax = [_grads(params, s) for s in range(len(LRS))]
    if clip:   # the clip acts
        assert np.sqrt(sum(np.sum(g ** 2) for g in jax.tree_util.tree_leaves(
            grads_jax[0]))) > tsb.grad_clip_norm(c)
    want = [_as_port(p, stats) for p in _jax_updates(c, params, grads_jax)]
    model, _ = create_visual_model(c)
    load_pretrain_weights(model, params, stats)
    init = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    grads = [_as_port(g, stats) for g in grads_jax]
    _, got = _port_steps(c, model, grads)
    names = [n for n, _ in model.named_parameters()]
    if trick and modality == "Flow":
        stem = "model.encoder.base_model.stage0.conv.weight"
        assert tsb.label_params_trick(model)[stem] == "first_conv_weight"
    for step, (ours, ref) in enumerate(zip(got, want)):
        for k in names:
            _assert_update(ours[k], ref[k], init[k], (step, k))


def _labels_through_bridge(jax_labels, params, stats, downstream=False):
    """JAX's labels moved to the port's parameter names: each label becomes
    an array of ``params``' shape filled with its index, carried by the
    weight bridge."""
    names = sorted(set(jax.tree_util.tree_leaves(jax_labels)))
    filled = jax.tree_util.tree_map(
        lambda lab, p: np.full(p.shape, float(names.index(lab)), np.float32),
        jax_labels, params)
    sd = _as_port(filled, stats, downstream)
    return {k: names[int(v.flat[0])] for k, v in sd.items() if "running" not in k}


@pytest.mark.parametrize("backbone,btype,modality,downstream", [
    ("S3D", "3D", "RGB", False), ("tiny3d", "3D", "Flow", False),
    ("resnet18", "2D", "RGB", False), ("resnet3d_10", "3D", "RGB", False),
    ("tiny3d", "3D", "RGB", True)])
def test_trick_labels_match_jax(tiny_cfg, backbone, btype, modality, downstream):
    params, stats = _jax_params(modality, backbone, btype, downstream)
    want = _labels_through_bridge(jsb.label_params_trick(params, modality), params, stats,
                                  downstream)
    c = _cfg(tiny_cfg, modality=modality, backbone=backbone, btype=btype)
    model = (create_video_model if downstream else create_visual_model)(c)[0]
    got = tsb.label_params_trick(model)
    assert got == {k: v for k, v in want.items() if k in got} and sorted(got) == sorted(
        k for k in want if k in dict(model.named_parameters()))
    assert "first_conv_weight" in got.values() and "bn" in got.values()
    if downstream:
        assert got["new_fc.weight"] == "fc_weight" and got["new_fc.bias"] == "fc_bias"


def test_simsiam_trick_labels_match_jax(tiny_cfg):
    from video_graph_ssl_tpu.config import cfg as jax_cfg

    c = _cfg(jax_cfg)
    c.CROSS.FEAT_DIM = 32
    c.CONTRAST.MEM_TYPE = "simsiam"
    _, _, params, stats = setup(c, (2, 2, 4, 16, 16, 3))
    params, stats = np_tree(params), np_tree(stats)
    want = _labels_through_bridge(jsb.label_params_trick(params), params, stats)
    model, _ = create_visual_model(c)
    got = tsb.label_params_trick(model)
    assert got == want
    assert sum(v == "bn" for v in got.values()) > 4


@pytest.mark.parametrize("name", ["Adam", "LARS"])
def test_linear_probe_freezes_and_keeps_no_state(tiny_cfg, name):
    c = _cfg(tiny_cfg, name)
    c.MODEL.LINEAR_PROBE = True
    params, stats = _jax_params("RGB", downstream=True)
    mask = jax.tree_util.tree_map_with_path(
        lambda path, _: any(getattr(k, "key", None) == "new_fc" for k in path), params)
    grads_jax = [_grads(params, 10 + s) for s in range(len(LRS))]
    want = [_as_port(p, stats, True) for p in _jax_updates(c, params, grads_jax, mask)]
    model, _ = create_video_model(c)
    load_downstream_weights(model, params, stats)
    init = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    opt, got = _port_steps(c, model, [_as_port(g, stats, True) for g in grads_jax],
                           is_probe_param)
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    for k, p in model.named_parameters():
        assert (id(p) in held) == is_probe_param(k)
        assert (p in opt.state) == is_probe_param(k)
    for ours, ref in zip(got, want):
        for k in init:
            if is_probe_param(k):
                _assert_update(ours[k], ref[k], init[k], k)
            else:
                np.testing.assert_array_equal(ours[k], init[k], err_msg=k)
                np.testing.assert_array_equal(ref[k], init[k], err_msg=k)


@pytest.mark.parametrize("mode", ["cos", "poly", "step"])
def test_iter_lr_scheduler_matches_jax(tiny_cfg, mode):
    c = tiny_cfg.clone()
    c.SOLVER.LR_SCHEDULER = mode
    c.SOLVER.MAX_EPOCHS = 6
    c.SOLVER.WARMUP_ITERS = 2
    c.SOLVER.LR_STEP = 2
    ours, ref = tsb.make_iter_lr_scheduler(c, 7), jsb.make_iter_lr_scheduler(c, 7)
    assert [ours(i) for i in range(6 * 7)] == [ref(i) for i in range(6 * 7)]


@pytest.mark.parametrize("spec", [
    {"type": "log"}, {"type": "step", "step": 5}, {"type": "step", "end_lr": 1e-4, "step": 7},
    {"type": "step", "start_lr": None, "end_lr": 1e-4, "step": 7},
    {"type": "multi-step", "steps": [5, 9]}, {"type": "multi-step", "end_lr": 1e-3},
    {"type": "multi-step", "start_lr": None, "end_lr": 1e-3}, {"type": "linear"},
    {"type": "cos", "start_lr": 0.1, "end_lr": 0.0},
    {"type": "cos", "warmup": {"type": "linear", "epoch": 5, "start_lr": 0.0,
                               "end_lr": 0.01}}])
def test_lr_spaces_match_jax(spec):
    ours, ref = tsb.build_lr_spaces(dict(spec), 30), jsb.build_lr_spaces(dict(spec), 30)
    assert ours.shape == (30,)
    np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError, match="Unknown type"):
        tsb.build_lr_spaces({"type": "exp"})


def test_unknown_optimizer_raises(tiny_cfg):
    c = _cfg(tiny_cfg, "RMSprop")
    with pytest.raises(ValueError, match="Unknown optimizer"):
        tsb.make_optimizer(c, create_visual_model(_cfg(tiny_cfg))[0])
