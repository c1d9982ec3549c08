"""Weight bridge: the JAX package's ``GraphWrapper`` variables -> the port's
``state_dict``, and a whole JAX ``TrainState`` -> the port's live
``PretrainState`` (:func:`pretrain_state_from_jax`); likewise a JAX
``VideoModel``'s variables -> the port's ``VideoModel``
(:func:`downstream_state_dict`, the names of JAX
``export_downstream_to_torch``) and a JAX downstream ``TrainState`` -> the
port's downstream state (:func:`downstream_state_from_jax`).

A JAX CMC tree (``params['model_1']``, ``params['model_2']``: JAX
``CmcWrapper``) maps to the port's ``CmcWrapper`` under
``model_{1,2}.<GraphWrapper names>``, the names of JAX
``export_cmc_pretrain_to_torch``; its dual queue or bank (``queue_1``,
``queue_2``, ``ptr``; ``memory_1``, ``memory_2``) carries over by name.

Numpy only (no JAX import): ``params`` and ``batch_stats`` are the JAX
model's nested dicts with numpy leaves.  The backbones: S3D, S3DG (S3D's
names, each SepConv conv's bias beside its weight), I3D (JAX ``conv3d_1a``,
``conv3d_2b``, ``conv3d_2c`` and the Mixed blocks' ``Unit3D``s -> the
port's stages 0, 2, 3 and the same branch paths as S3D's), the ResNets (2D,
R3D, resnet_i3d and R(2+1)D: JAX ``layerS_B`` -> ``layerS.B``, the block
fields to the reference's names), BN-Inception, Inception-v3 and tiny3d,
told apart by :func:`backbone_of`, and i3d_res50_nonlocal (R3D's field
names, its non-local blocks at ``layerS.B.non_local``).  The text-video
``S3DGText`` maps on its own (:func:`s3dg_text_state_dict`, the MIL-NCE
names).  Names are the reference's, the
same that ``video_graph_ssl_tpu.utils.ckpt_convert.export_pretrain_to_torch``
writes for S3D: ``model.proj_head.head.{0,2}`` (MoCo, bank) or
``model.projection.l{1,2,3}.{0,1}`` and ``model.prediction.{l1.{0,1},l2}``
(SimSiam).  Layout rules: a flax conv kernel (*window, cin, cout)
becomes (cout, cin, *window); a Dense kernel (in, out) is transposed; a
graph block's Dense becomes a 1x1x1 conv; BN scale/bias/mean/var become
weight/bias/running_mean/running_var.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from .checkpoint import restore_contrast

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
    """A flax conv kernel (*window, cin, cout) -> torch's (cout, cin, *window)."""
    k = np.asarray(k)
    return np.ascontiguousarray(np.transpose(k, (k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))))


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
    ``temporal_bias`` (S3DG) each SepConv conv's bias comes along.  A
    folded stem (JAX ``S3D(stem_s2d=...)``, ``SepConvS2D``: the same
    ``spatial``/``temporal`` subtrees, (1, 4, 4) and (4, 1, 1) kernels)
    maps onto the port's ``SepConvS2D`` under the same names."""
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


def _leaf(out: SD, name: str, p: dict, s: dict) -> None:
    """A JAX conv (``{kernel}``) or BN wrapper (``{bn: ...}``) at ``name``."""
    if "kernel" in p:
        out[name + ".weight"] = _conv_kernel(p["kernel"])
    else:
        _bn(out, name, p["bn"], s["bn"])


# JAX ResNet block fields -> the port's (the reference's) names; a field
# not listed keeps its name (conv1, bn1, ...)
_SHORTCUT = {"ds_conv": "downsample.0", "ds_bn": "downsample.1"}
_FBASIC = {**_SHORTCUT, **{k.format(i): v.format(i) for i in (1, 2) for k, v in (
    ("conv{}_s", "conv{}_1"), ("conv{}_s_bn", "bn{}_1"), ("conv{}_t", "conv{}_2"),
    ("conv{}_t_bn", "bn{}_2"))}}
_FBOTTLENECK = {**_SHORTCUT, "conv2_s": "conv2.conv1", "bn2_s": "conv2.bn1",
                "conv2_t": "conv2.conv2", "bn2_t": "conv2.bn2", "bn3": "bn2"}
_R2P1D_STEM = {"stem_s": "conv1_s", "stem_bn_s": "bn1_s", "stem_t": "conv1_t",
               "stem_bn_t": "bn1_t"}


def _nonlocal(out: SD, prefix: str, p: dict, s: dict) -> None:
    """A JAX ``NonLocalBlock3D``: its four Dense as Linears, ``w_bn``."""
    for name in ("theta", "phi", "g", "w_out"):
        _dense(out, f"{prefix}.{name}", p[name])
    _bn(out, f"{prefix}.w_bn", p["w_bn"]["bn"], s["w_bn"]["bn"])


def _resnet_block(out: SD, prefix: str, p: dict, s: dict) -> None:
    """One JAX ResNet block (R3D, resnet_i3d, R(2+1)D, 2D or i3dnon's
    inflated bottleneck, its non-local block at ``non_local``) at
    ``prefix``."""
    if "conv1_s" in p:
        table = _FBASIC
    elif "conv2_s" in p:
        table = _FBOTTLENECK
    else:
        table = _SHORTCUT
    for field, sub in p.items():
        if field == "nonlocal":
            _nonlocal(out, f"{prefix}.non_local", sub, s.get(field, {}))
        elif "spatial" in sub:    # an R(2+1)D pair: its BN after it is bn{i}_t
            i = field[len("conv"):]
            out[f"{prefix}.conv{i}_s.weight"] = _conv_kernel(sub["spatial"]["kernel"])
            _bn(out, f"{prefix}.bn{i}_s", sub["bn_s"]["bn"], s[field]["bn_s"]["bn"])
            out[f"{prefix}.conv{i}_t.weight"] = _conv_kernel(sub["temporal"]["kernel"])
        elif field.startswith("bn") and f"conv{field[2:]}" in p and "spatial" in p[
                f"conv{field[2:]}"]:
            _bn(out, f"{prefix}.{field}_t", sub["bn"], s[field]["bn"])
        else:
            _leaf(out, f"{prefix}.{table.get(field, field)}", sub, s.get(field, {}))


def resnet_state_dict(p: dict, s: dict, sub_sample: bool = True) -> SD:
    """JAX ``ResNet2D``, ``ResNet3D`` (R3D, resnet_i3d), ``ResNet2Plus1D`` or
    ``I3DResNetNonLocal`` variables -> the port's state_dict: torchvision's stem and stage names,
    or R(2+1)D's ``conv1_s``/``conv1_t`` stem; a stage with a graph block
    ``graph_aug_S`` is ``layerS.1``, the block ``layerS.0``."""
    out: SD = {}
    for field, sub in p.items():
        if field.startswith("layer"):
            stage, b = field[len("layer"):].split("_")
            wrap = ".1" if f"graph_aug_{stage}" in p else ""
            _resnet_block(out, f"layer{stage}{wrap}.{b}", sub, s[field])
        elif field.startswith("graph_aug_"):
            _graph(out, f"layer{field.rsplit('_', 1)[1]}.0", sub, s.get(field, {}),
                   sub_sample)
        else:
            _leaf(out, _R2P1D_STEM.get(field, field), sub, s.get(field, {}))
    return out


# JAX BN-Inception branch modules -> the port's (the reference's) paths
_BNINC_REGULAR = {"branch1": "branch1", "branch2_reduce": "branch2.0", "branch2": "branch2.1",
                  "branch3_reduce": "branch3.0", "branch3_mid": "branch3.1",
                  "branch3": "branch3.2", "branch4": "branch4.1"}
_BNINC_REDUCE = {"branch1_reduce": "branch1.0", "branch1": "branch1.1",
                 "branch2_reduce": "branch2.0", "branch2_mid": "branch2.1",
                 "branch2": "branch2.2"}


def _basic2d(out: SD, prefix: str, p: dict, s: dict) -> None:
    """A JAX conv + BN unit (``{conv, bn}``) -> ``prefix.conv``/``prefix.bn``."""
    out[prefix + ".conv.weight"] = _conv_kernel(p["conv"]["kernel"])
    _bn(out, prefix + ".bn", p["bn"], s["bn"])


def bninception_state_dict(p: dict, s: dict, sub_sample: bool = True) -> SD:
    """JAX ``BNInception`` variables -> the port's ``BNInception`` state_dict."""
    out: SD = {}
    for name, sub in p.items():
        if "conv" in sub:
            _basic2d(out, name, sub, s[name])
            continue
        table = _BNINC_REGULAR if "branch4" in sub else _BNINC_REDUCE
        for branch, path in table.items():
            _basic2d(out, f"{name}.{path}", sub[branch], s[name][branch])
    return out


# JAX Inception-v3 modules -> the reference's (JAX utils/torch_interop.py
# _INC3_STEMS, _INC3_BRANCHES, _INC3_BLOCKS)
_INC3_STEMS = {"conv1a": "Conv2d_1a_3x3", "conv2a": "Conv2d_2a_3x3", "conv2b": "Conv2d_2b_3x3",
               "conv3b": "Conv2d_3b_1x1", "conv4a": "Conv2d_4a_3x3"}
_INC3_BRANCHES = {
    "A": {"b1x1": "branch1x1", "b5_1": "branch5x5_1", "b5_2": "branch5x5_2",
          "b3_1": "branch3x3dbl_1", "b3_2": "branch3x3dbl_2", "b3_3": "branch3x3dbl_3",
          "bpool": "branch_pool"},
    "B": {"b3": "branch3x3", "bd_1": "branch3x3dbl_1", "bd_2": "branch3x3dbl_2",
          "bd_3": "branch3x3dbl_3"},
    "C": {"b1x1": "branch1x1", "bpool": "branch_pool",
          **{f"b7_{i}": f"branch7x7_{i}" for i in range(1, 4)},
          **{f"bd_{i}": f"branch7x7dbl_{i}" for i in range(1, 6)}},
    "D": {"b3_1": "branch3x3_1", "b3_2": "branch3x3_2",
          **{f"b7_{i}": f"branch7x7x3_{i}" for i in range(1, 5)}},
    "E": {"b1x1": "branch1x1", "b3_1": "branch3x3_1", "b3_2a": "branch3x3_2a",
          "b3_2b": "branch3x3_2b", "bd_1": "branch3x3dbl_1", "bd_2": "branch3x3dbl_2",
          "bd_3a": "branch3x3dbl_3a", "bd_3b": "branch3x3dbl_3b", "bpool": "branch_pool"},
}
_INC3_FAMILY = {"5b": "A", "5c": "A", "5d": "A", "6a": "B", "6b": "C", "6c": "C",
                "6d": "C", "6e": "C", "7a": "D", "7b": "E", "7c": "E"}


def inception_v3_state_dict(p: dict, s: dict, sub_sample: bool = True) -> SD:
    """JAX ``InceptionV3`` variables -> the port's ``InceptionV3`` state_dict."""
    out: SD = {}
    for name, sub in p.items():
        if name in _INC3_STEMS:
            _basic2d(out, _INC3_STEMS[name], sub, s[name])
            continue
        key = name[len("mixed_"):]
        table = _INC3_BRANCHES[_INC3_FAMILY[key]]
        for field, unit in sub.items():
            _basic2d(out, f"Mixed_{key}.{table[field]}", unit, s[name][field])
    return out


_RESNET_DEPTHS = {((1, 1, 1, 1), False): 10, ((2, 2, 2, 2), False): 18,
                  ((3, 4, 6, 3), False): 34, ((3, 4, 6, 3), True): 50,
                  ((3, 4, 23, 3), True): 101, ((3, 8, 36, 3), True): 152,
                  ((3, 24, 36, 3), True): 200}


I3DNON = "i3d_res50_nonlocal"


def _is_i3dnon(enc: dict) -> bool:
    """JAX ``I3DResNetNonLocal`` variables, whose field names are R3D's: by
    the non-local block in ``layer2_1`` or the (5, 7, 7) stem kernel (R3D's
    is 7x7x7, R(2+1)D's a pair)."""
    stem = enc.get("conv1", {}).get("kernel")
    return ("nonlocal" in enc.get("layer2_1", {})
            or (stem is not None and tuple(np.shape(stem)[:3]) == (5, 7, 7)))


def _resnet_name(enc: dict) -> str:
    """The registry name of a JAX ResNet's variables: the family by its stem
    and blocks, the depth by its block counts and block type; I3D-ResNet-50
    with non-local blocks by :func:`_is_i3dnon`."""
    if _is_i3dnon(enc):
        return I3DNON
    layers = tuple(sum(k.startswith(f"layer{s}_") for k in enc) for s in (1, 2, 3, 4))
    first = enc["layer1_0"]
    depth = _RESNET_DEPTHS[layers, "conv3" in first]
    if "stem_s" in enc:
        return f"resnet2p1d_{depth}"
    if np.ndim(enc["conv1"]["kernel"]) == 4:
        return f"resnet{depth}"
    if "conv1_s" in first or "conv2_s" in first:
        return f"resnet_i3d_{depth}"
    return f"resnet3d_{depth}"


BACKBONES = {"S3D": s3d_state_dict, "S3DG": s3d_state_dict, "I3D": i3d_state_dict,
             "InceptionI3d": i3d_state_dict, "tiny3d": tiny3d_state_dict,
             "bninception": bninception_state_dict,
             "inception_v3": inception_v3_state_dict, I3DNON: resnet_state_dict,
             **{f"{family}{d}": resnet_state_dict
                for family, depths in (("resnet", (18, 34, 50, 101, 152)),
                                       ("resnet3d_", (10, 18, 34, 50, 101, 152, 200)),
                                       ("resnet2p1d_", (10, 18, 34, 50, 101, 152, 200)),
                                       ("resnet_i3d_", (18, 50, 101)))
                for d in depths}}


def backbone_of(enc: dict) -> str:
    """The backbone of a JAX encoder's ``base_model`` variables (params or
    an optimizer trace of them): I3D by its ``conv3d_1a`` tree, S3DG by its
    conv biases, S3D, BN-Inception and Inception-v3 by their blocks, a
    ResNet by :func:`_resnet_name`, else tiny3d."""
    if "conv3d_1a" in enc:
        return "I3D"
    if "mixed_3b" in enc:
        return "S3DG" if "bias" in enc["stem_0"]["spatial"]["conv"] else "S3D"
    if "inception3a" in enc:
        return "bninception"
    if "mixed_5b" in enc:
        return "inception_v3"
    if "layer1_0" in enc:
        return _resnet_name(enc)
    return "tiny3d"


def _dense(out: SD, name: str, d: dict) -> None:
    out[name + ".weight"] = np.ascontiguousarray(np.asarray(d["kernel"]).T)
    out[name + ".bias"] = np.asarray(d["bias"])


def _stconv_text(out: SD, prefix: str, p: dict, s: dict) -> None:
    """A JAX ``s3dg_text.STConv`` (``conv1``/``bn1`` [``conv2``/``bn2``],
    flax BatchNorm unwrapped) at ``prefix``."""
    for i in (1, 2):
        if f"conv{i}" in p:
            out[f"{prefix}.conv{i}.weight"] = _conv_kernel(p[f"conv{i}"]["kernel"])
            _bn(out, f"{prefix}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])


def s3dg_text_state_dict(params: dict, batch_stats: dict) -> SD:
    """JAX ``S3DGText`` variables (``encode_video``, ``text_module``) -> the
    port's ``S3DGText`` state_dict, the MIL-NCE names (the inverse of JAX
    ``convert_torch_s3dg_text``)."""
    out: SD = {}
    p, s = params["encode_video"], batch_stats.get("encode_video", {})
    for name, sub in p.items():
        if name in ("gating", "fc"):
            _dense(out, f"{name}.fc" if name == "gating" else name,
                   sub["fc"] if name == "gating" else sub)
        elif name.startswith("mixed_"):
            for branch, bp in sub.items():
                if branch.startswith("gating_"):
                    _dense(out, f"{name}.{branch}.fc", bp["fc"])
                else:
                    _stconv_text(out, f"{name}.{branch}", bp, s[name][branch])
        else:
            _stconv_text(out, name, sub, s[name])
    if "text_module" in params:
        t = params["text_module"]
        out["text_module.word_embd.weight"] = np.asarray(t["word_embd"]["embedding"])
        for fc in ("fc1", "fc2"):
            _dense(out, f"text_module.{fc}", t[fc])
    return out


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


CMC_STACKS = ("model_1", "model_2")


def _root(params: dict) -> str:
    """The first encoder stack of a JAX pretrain tree: ``model``, or CMC's
    ``model_1``."""
    return CMC_STACKS[0] if CMC_STACKS[0] in params else "model"


def pretrain_state_dict(params: dict, batch_stats: dict, backbone: str = None,
                        head_type: str = "mlp", graph_sub_sample: bool = True) -> SD:
    """JAX ``GraphWrapper`` variables (contrastive or SimSiam, told apart by
    their heads) -> the port's ``GraphWrapper`` state_dict, as numpy
    arrays; JAX ``CmcWrapper`` variables (``model_1``, ``model_2``) -> the
    port's ``CmcWrapper``'s, each stack's names under its own prefix;
    ``backbone`` defaults to :func:`backbone_of` the params."""
    if _root(params) != "model":
        return {f"{stack}.{k}": v for stack in CMC_STACKS
                for k, v in pretrain_state_dict(
                    {"model": params[stack]}, {"model": batch_stats[stack]}, backbone,
                    head_type, graph_sub_sample).items()}
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
    CMC's two of either; SimSiam has none) and the step.  The backbone,
    head and graph naming are read off the two states.

    The JAX optimizer scales a bias gradient by ``SOLVER.BIAS_LR_FACTOR``
    *before* ``optax.trace`` (JAX ``solver/build.py:163-168``); the port
    puts the factor in the bias group's lr instead (``solver/build.py``), so
    a JAX trace is the group's ``lr_factor`` times the port's buffer and is
    divided by it here."""
    top = tree["params"][_root(tree["params"])]
    backbone = backbone_of(top["encoder"]["base_model"])
    head = "linear" if "fc" in top.get("proj_head", {}) else "mlp"
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
        opt.state[p]["momentum_buffer"] = torch.empty_like(p).copy_(buf)
    contrast = tree.get("contrast") or None
    if (state.contrast is None) != (contrast is None):
        raise KeyError("the JAX state and the port's disagree on a contrast memory")
    if contrast is not None:
        restore_contrast(state.contrast, {k: np.array(v) for k, v in contrast.items()},
                         "the JAX state")
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
        opt.state[p]["momentum_buffer"] = torch.empty_like(p).copy_(buf)
    state.step = int(tree["step"])
