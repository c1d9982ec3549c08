"""Weight bridge: the JAX package's ``GraphWrapper`` variables -> the port's
``state_dict``.

Numpy only (no JAX import): ``params`` and ``batch_stats`` are the JAX
model's nested dicts with numpy leaves.  Names are the reference's, the
same that ``video_graph_ssl_tpu.utils.ckpt_convert.export_pretrain_to_torch``
writes for S3D.  Layout rules: a flax conv kernel (kt, kh, kw, cin, cout)
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


def s3d_state_dict(p: dict, s: dict, sub_sample: bool = True) -> SD:
    """JAX ``S3D`` variables -> the port's ``S3D`` state_dict."""
    out: SD = {}
    for ours, (idx, kind) in _S3D_STAGES.items():
        wrapped = f"graph_aug_{idx}" in p
        base = f"base.{idx}" + (".1" if wrapped else "")
        if kind == "mixed":
            for bname, (path, bkind) in _MIXED_BRANCHES.items():
                fn = _sep if bkind == "sep" else _basic
                fn(out, f"{base}.{path}", p[ours][bname], s[ours][bname])
        else:
            (_sep if kind == "sep" else _basic)(out, base, p[ours], s[ours])
    for name in p:
        if name.startswith("graph_aug_"):
            idx = int(name.rsplit("_", 1)[1])
            _graph(out, f"base.{idx}.0", p[name], s.get(name, {}), sub_sample)
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


BACKBONES = {"S3D": s3d_state_dict, "tiny3d": tiny3d_state_dict}


def pretrain_state_dict(params: dict, batch_stats: dict, backbone: str = "S3D",
                        head_type: str = "mlp", graph_sub_sample: bool = True) -> SD:
    """JAX ``GraphWrapper`` (contrastive) variables -> the port's
    ``GraphWrapper`` state_dict, as numpy arrays."""
    mp, ms = params["model"], batch_stats["model"]
    enc = BACKBONES[backbone](mp["encoder"]["base_model"],
                              ms["encoder"]["base_model"], graph_sub_sample)
    out = {f"model.encoder.base_model.{k}": v for k, v in enc.items()}
    heads = ((("fc", "head.0"),) if head_type == "linear"
             else (("fc1", "head.0"), ("fc2", "head.2")))
    for jname, tname in heads:
        d = mp["proj_head"][jname]
        out[f"model.proj_head.{tname}.weight"] = np.ascontiguousarray(
            np.asarray(d["kernel"]).T)
        out[f"model.proj_head.{tname}.bias"] = np.asarray(d["bias"])
    return out


def load_pretrain_weights(model: nn.Module, params: dict, batch_stats: dict,
                          backbone: str = "S3D", head_type: str = "mlp",
                          graph_sub_sample: bool = True) -> None:
    """Load the JAX variables into the port's model with ``strict=True``."""
    sd = pretrain_state_dict(params, batch_stats, backbone, head_type,
                             graph_sub_sample)
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in sd.items()}, strict=True)
