"""Weight bridge: the JAX package's ``GraphWrapper`` variables -> the port's
``state_dict``, and a whole JAX ``TrainState`` -> the port's live
``PretrainState`` (:func:`pretrain_state_from_jax`); likewise a JAX
``VideoModel``'s variables -> the port's ``VideoModel``
(:func:`downstream_state_dict`, the names of JAX
``export_downstream_to_torch``) and a JAX downstream ``TrainState`` -> the
port's downstream state (:func:`downstream_state_from_jax`).

Numpy only (no JAX import): ``params`` and ``batch_stats`` are the JAX
model's nested dicts with numpy leaves.  The backbones: S3D, S3DG (S3D's
names, each SepConv conv's bias beside its weight), I3D (JAX ``conv3d_1a``,
``conv3d_2b``, ``conv3d_2c`` and the Mixed blocks' ``Unit3D``s -> the
port's stages 0, 2, 3 and the same branch paths as S3D's) and tiny3d,
told apart by :func:`backbone_of`.  Names are the reference's, the
same that ``video_graph_ssl_tpu.utils.ckpt_convert.export_pretrain_to_torch``
writes for S3D: ``model.proj_head.head.{0,2}`` (MoCo, bank) or
``model.projection.l{1,2,3}.{0,1}`` and ``model.prediction.{l1.{0,1},l2}``
(SimSiam).  Layout rules: a flax conv kernel (kt, kh, kw, cin, cout)
becomes (cout, cin, kt, kh, kw); a Dense kernel (in, out) is transposed; a
graph block's Dense becomes a 1x1x1 conv; BN scale/bias/mean/var become
weight/bias/running_mean/running_var.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

_S3D_STAGES = {
    "stem_0": (0, "sep"), "stem_2": (2, "basic"), "stem_3": (3, "sep"),
    "mixed_3b": (5, "mixed"), "mixed_3c": (6, "mixed"),
    "mixed_4b": (8, "mixed"), "mixed_4c": (9, "mixed"),
    "mixed_4d": (10, "mixed"), "mixed_4e": (11, "mixed"),
    "mixed_4f": (12, "mixed"), "mixed_5b": (14, "mixed"),
    "mixed_5c": (15, "mixed"),
}

# JAX branch submodule -> (torch path inside the block, kind)
_MIXED_BRANCHES = {
    "branch0": ("branch0.0", "basic"),
    "branch1_reduce": ("branch1.0", "basic"),
    "branch1": ("branch1.1", "sep"),
    "branch2_reduce": ("branch2.0", "basic"),
    "branch2": ("branch2.1", "sep"),
    "branch3": ("branch3.1", "basic"),   # after the branch's max pool
}

SD = Dict[str, np.ndarray]


def _conv_kernel(k) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(k), (4, 3, 0, 1, 2)))


def _dense_as_conv(k) -> np.ndarray:
    k = np.asarray(k)
    return np.ascontiguousarray(k.T.reshape(k.shape[1], k.shape[0], 1, 1, 1))


def _bn(out: SD, name: str, p: dict, s: dict) -> None:
    out[name + ".weight"] = np.asarray(p["scale"])
    out[name + ".bias"] = np.asarray(p["bias"])
    out[name + ".running_mean"] = np.asarray(s["mean"])
    out[name + ".running_var"] = np.asarray(s["var"])


def _convbn(out: SD, conv: str, bn: str, p: dict, s: dict) -> None:
    out[conv + ".weight"] = _conv_kernel(p["conv"]["kernel"])
    if "bias" in p["conv"]:     # S3DG's SepConv pairs
        out[conv + ".bias"] = np.asarray(p["conv"]["bias"])
    _bn(out, bn, p["bn"], s["bn"])


def _basic(out: SD, prefix: str, p: dict, s: dict) -> None:
    _convbn(out, prefix + ".conv", prefix + ".bn", p["block"], s["block"])


def _sep(out: SD, prefix: str, p: dict, s: dict) -> None:
    _convbn(out, prefix + ".conv_s", prefix + ".bn_s", p["spatial"], s["spatial"])
    _convbn(out, prefix + ".conv_t", prefix + ".bn_t", p["temporal"], s["temporal"])


def graph_aug_state_dict(p: dict, s: dict, sub_sample: bool = True) -> SD:
    """One JAX ``TemporalGraphAug`` -> the port's block state_dict.
    ``sub_sample`` is the block's GRAPH.SUB_SAMPLE: the reference nests the
    q/k conv with the parameter-free pool, which shifts its name."""
    out: SD = {}
    for stem in ("g_q", "g_k"):
        has_bn = f"{stem}_bn" in p
        conv = stem + (".0" if has_bn else "")
        if sub_sample:
            conv = f"{stem}.0.0" if has_bn else f"{stem}.0"
        out[f"{conv}.weight"] = _dense_as_conv(p[stem]["kernel"])
        if "bias" in p[stem]:
            out[f"{conv}.bias"] = np.asarray(p[stem]["bias"])
        if has_bn:
            _bn(out, f"{conv[:-1]}1", p[f"{stem}_bn"], s[f"{stem}_bn"])
    i = 0
    while f"gcn_{i}" in p:
        t = p[f"gcn_{i}"]["transform"]
        out[f"gcns.{i}.conv.weight"] = _dense_as_conv(t["kernel"])
        if "bias" in t:
            out[f"gcns.{i}.conv.bias"] = np.asarray(t["bias"])
        i += 1
    return out


def _graph(out: SD, prefix: str, p: dict, s: dict, sub_sample: bool) -> None:
    for k, v in graph_aug_state_dict(p, s, sub_sample).items():
        out[f"{prefix}.{k}"] = v


def _graphs(out: SD, p: dict, s: dict, sub_sample: bool) -> None:
    """The graph blocks of a staged backbone (``base.{idx}.0``)."""
    for name in p:
        if name.startswith("graph_aug_"):
            idx = int(name.rsplit("_", 1)[1])
            _graph(out, f"base.{idx}.0", p[name], s.get(name, {}), sub_sample)


def _stage(p: dict, idx: int) -> str:
    return f"base.{idx}" + (".1" if f"graph_aug_{idx}" in p else "")


def s3d_state_dict(p: dict, s: dict, sub_sample: bool = True) -> SD:
    """JAX ``S3D`` variables -> the port's ``S3D`` state_dict; with
    ``temporal_bias`` (S3DG) each SepConv conv's bias comes along."""
    out: SD = {}
    for ours, (idx, kind) in _S3D_STAGES.items():
        base = _stage(p, idx)
        if kind == "mixed":
            for bname, (path, bkind) in _MIXED_BRANCHES.items():
                fn = _sep if bkind == "sep" else _basic
                fn(out, f"{base}.{path}", p[ours][bname], s[ours][bname])
        else:
            (_sep if kind == "sep" else _basic)(out, base, p[ours], s[ours])
    _graphs(out, p, s, sub_sample)
    return out


# JAX I3D's units -> the port's stage (JAX i3d.py:164-187); the Mixed blocks
# are S3D's stages, their Unit3Ds at S3D's branch paths
_I3D_UNITS = {"conv3d_1a": 0, "conv3d_2b": 2, "conv3d_2c": 3}


def i3d_state_dict(p: dict, s: dict, sub_sample: bool = True) -> SD:
    """JAX ``I3D`` variables -> the port's ``I3D`` state_dict."""
    out: SD = {}
    for ours, idx in _I3D_UNITS.items():
        base = _stage(p, idx)
        _convbn(out, base + ".conv", base + ".bn", p[ours], s[ours])
    for ours, (idx, kind) in _S3D_STAGES.items():
        if kind != "mixed":
            continue
        base = _stage(p, idx)
        for bname, (path, _) in _MIXED_BRANCHES.items():
            _convbn(out, f"{base}.{path}.conv", f"{base}.{path}.bn", p[ours][bname],
                    s[ours][bname])
    _graphs(out, p, s, sub_sample)
    return out


def tiny3d_state_dict(p: dict, s: dict, sub_sample: bool = True) -> SD:
    """JAX ``Tiny3D`` variables -> the port's ``Tiny3D`` state_dict."""
    out: SD = {}
    for stage in ("stage0", "stage1", "stage2"):
        _basic(out, stage, p[stage], s[stage])
    if "graph_aug_1" in p:
        _graph(out, "graph_aug_1", p["graph_aug_1"], s.get("graph_aug_1", {}),
               sub_sample)
    return out


BACKBONES = {"S3D": s3d_state_dict, "S3DG": s3d_state_dict, "I3D": i3d_state_dict,
             "InceptionI3d": i3d_state_dict, "tiny3d": tiny3d_state_dict}


def backbone_of(enc: dict) -> str:
    """The backbone of a JAX encoder's ``base_model`` variables (params or
    an optimizer trace of them): I3D by its ``conv3d_1a`` tree, S3DG by its
    conv biases, S3D, else tiny3d."""
    if "conv3d_1a" in enc:
        return "I3D"
    if "mixed_3b" in enc:
        return "S3DG" if "bias" in enc["stem_0"]["spatial"]["conv"] else "S3D"
    return "tiny3d"


def _dense(out: SD, name: str, d: dict) -> None:
    out[name + ".weight"] = np.ascontiguousarray(np.asarray(d["kernel"]).T)
    out[name + ".bias"] = np.asarray(d["bias"])


def simsiam_heads_state_dict(p: dict, s: dict) -> SD:
    """JAX SimSiam ``projection`` and ``prediction`` MLPs (``p``/``s``: the
    ``model`` subtrees of params and batch_stats) -> the port's names."""
    out: SD = {}
    for head, layers in (("projection", ("l1", "l2", "l3")), ("prediction", ("l1",))):
        for l in layers:
            _dense(out, f"model.{head}.{l}.0", p[head][l]["fc"])
            _bn(out, f"model.{head}.{l}.1", p[head][l]["bn"], s[head][l]["bn"])
    _dense(out, "model.prediction.l2", p["prediction"]["l2"])
    return out


def pretrain_state_dict(params: dict, batch_stats: dict, backbone: str = None,
                        head_type: str = "mlp", graph_sub_sample: bool = True) -> SD:
    """JAX ``GraphWrapper`` variables (contrastive or SimSiam, told apart by
    their heads) -> the port's ``GraphWrapper`` state_dict, as numpy
    arrays; ``backbone`` defaults to :func:`backbone_of` the params."""
    mp, ms = params["model"], batch_stats["model"]
    backbone = backbone or backbone_of(mp["encoder"]["base_model"])
    enc = BACKBONES[backbone](mp["encoder"]["base_model"],
                              ms["encoder"]["base_model"], graph_sub_sample)
    out = {f"model.encoder.base_model.{k}": v for k, v in enc.items()}
    if "projection" in mp:
        out.update(simsiam_heads_state_dict(mp, ms))
        return out
    heads = ((("fc", "head.0"),) if head_type == "linear"
             else (("fc1", "head.0"), ("fc2", "head.2")))
    for jname, tname in heads:
        _dense(out, f"model.proj_head.{tname}", mp["proj_head"][jname])
    return out


def load_pretrain_weights(model: nn.Module, params: dict, batch_stats: dict,
                          backbone: str = None, head_type: str = "mlp",
                          graph_sub_sample: bool = True) -> None:
    """Load the JAX variables into the port's model with ``strict=True``."""
    sd = pretrain_state_dict(params, batch_stats, backbone, head_type,
                             graph_sub_sample)
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in sd.items()}, strict=True)


def _find_key(tree, key: str):
    """The first value under ``key`` in a nested dict, depth first."""
    if not isinstance(tree, dict):
        return None
    if key in tree:
        return tree[key]
    for v in tree.values():
        found = _find_key(v, key)
        if found is not None:
            return found
    return None


def pretrain_state_from_jax(tree: dict, state) -> None:
    """Load a JAX ``TrainState`` (the state dict of a ``.msgpack``
    checkpoint's ``state``, numpy leaves) into the port's live
    ``PretrainState``: params and BN statistics, the EMA params and EMA BN
    statistics (MoCo), the SGD momentum traces as ``momentum_buffer``s, the
    contrast memory (the MoCo queue and its pointer, or the bank's rows;
    SimSiam has none) and the step.  The backbone, head and graph naming are
    read off the two states.

    The JAX optimizer scales a bias gradient by ``SOLVER.BIAS_LR_FACTOR``
    *before* ``optax.trace`` (JAX ``solver/build.py:163-168``); the port
    puts the factor in the bias group's lr instead (``solver/build.py``), so
    a JAX trace is the group's ``lr_factor`` times the port's buffer and is
    divided by it here."""
    backbone = backbone_of(tree["params"]["model"]["encoder"]["base_model"])
    head = "linear" if "fc" in tree["params"]["model"].get("proj_head", {}) else "mlp"
    want = set(state.model.state_dict())
    for sub_sample in (True, False):
        names = dict(backbone=backbone, head_type=head, graph_sub_sample=sub_sample)
        sd = pretrain_state_dict(tree["params"], tree["batch_stats"], **names)
        if set(sd) == want:
            break
    else:
        raise KeyError(f"the JAX {backbone} state does not name the port's "
                       f"parameters: {sorted(want ^ set(sd))[:8]}")

    def load(module, params, stats):
        module.load_state_dict(
            {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in pretrain_state_dict(params, stats, **names).items()},
            strict=True)

    load(state.model, tree["params"], tree["batch_stats"])
    if (state.ema_model is None) != (not tree.get("ema_params")):
        raise KeyError("the JAX state and the port's disagree on an EMA encoder")
    if state.ema_model is not None:
        load(state.ema_model, tree["ema_params"], tree["ema_batch_stats"])

    trace = _find_key(tree["opt_state"], "trace")
    if trace is None:
        raise KeyError("no optax trace (SGD momentum) in the JAX opt_state")
    traces = pretrain_state_dict(trace, tree["batch_stats"], **names)
    opt = state.optimizer
    factor = {id(p): g["lr_factor"] for g in opt.param_groups for p in g["params"]}
    for name, p in state.model.named_parameters():
        buf = torch.from_numpy(np.array(traces[name], np.float32) / factor[id(p)])
        opt.state[p]["momentum_buffer"] = buf.to(p.device).contiguous(
            memory_format=torch.channels_last_3d if p.dim() == 5
            else torch.contiguous_format)
    contrast = tree.get("contrast") or None
    if (state.contrast is None) != (contrast is None):
        raise KeyError("the JAX state and the port's disagree on a contrast memory")
    if contrast is not None and "queue" in contrast:
        state.contrast.queue.copy_(torch.from_numpy(np.array(contrast["queue"])))
        state.contrast.ptr = int(contrast["ptr"])
    elif contrast is not None:
        state.contrast.memory.copy_(torch.from_numpy(np.array(contrast["memory"])))
    state.step = int(tree["step"])


def downstream_state_dict(params: dict, batch_stats: dict, backbone: str = None,
                          graph_sub_sample: bool = True) -> SD:
    """JAX ``VideoModel`` variables -> the port's ``VideoModel`` state_dict
    (``base_model.*``, ``new_fc.*``), as numpy arrays; ``backbone``
    defaults to :func:`backbone_of` the params."""
    enc = BACKBONES[backbone or _backbone_of(params)](params["encoder"]["base_model"],
                              batch_stats["encoder"]["base_model"], graph_sub_sample)
    out = {f"base_model.{k}": v for k, v in enc.items()}
    _dense(out, "new_fc", params["new_fc"])
    return out


def _backbone_of(params: dict) -> str:
    return backbone_of(params["encoder"]["base_model"])


def load_downstream_weights(model: nn.Module, params: dict, batch_stats: dict,
                            backbone: str = None, graph_sub_sample: bool = True) -> None:
    """Load JAX ``VideoModel`` variables into the port's with ``strict=True``."""
    sd = downstream_state_dict(params, batch_stats, backbone, graph_sub_sample)
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in sd.items()}, strict=True)


def downstream_state_from_jax(tree: dict, state) -> None:
    """Load a JAX downstream ``TrainState`` (a ``.msgpack`` checkpoint's
    ``state``, numpy leaves) into the port's downstream state: parameters,
    BN statistics, the SGD momentum of the parameters the port's optimizer
    holds (all of them, or ``new_fc``'s for the linear probe; bias traces
    divided by their ``lr_factor`` as in :func:`pretrain_state_from_jax`)
    and the step."""
    backbone = _backbone_of(tree["params"])
    want = set(state.model.state_dict())
    for sub_sample in (True, False):
        sd = downstream_state_dict(tree["params"], tree["batch_stats"], backbone, sub_sample)
        if set(sd) == want:
            break
    else:
        raise KeyError(f"the JAX {backbone} state does not name the port's "
                       f"parameters: {sorted(want ^ set(sd))[:8]}")
    state.model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                                 for k, v in sd.items()}, strict=True)
    trace = _find_key(tree["opt_state"], "trace")
    if trace is None:
        raise KeyError("no optax trace (SGD momentum) in the JAX opt_state")
    traces = downstream_state_dict(trace, tree["batch_stats"], backbone, sub_sample)
    opt = state.optimizer
    factor = {id(p): g["lr_factor"] for g in opt.param_groups for p in g["params"]}
    for name, p in state.model.named_parameters():
        if id(p) not in factor:
            continue
        buf = torch.from_numpy(np.array(traces[name], np.float32) / factor[id(p)])
        opt.state[p]["momentum_buffer"] = buf.to(p.device).contiguous(
            memory_format=torch.channels_last_3d if p.dim() == 5
            else torch.contiguous_format)
    state.step = int(tree["step"])
