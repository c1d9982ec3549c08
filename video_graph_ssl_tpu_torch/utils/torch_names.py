"""The reference's backbone names -> the port's, without JAX: a state_dict
of the reference's S3DG (S3DG_Pytorch.py:310-335), I3D (i3dpt.py:161-262),
ResNets (2D torchvision, R3D, R(2+1)D, resnet_i3d), BN-Inception or
Inception-v3 becomes one that the port's backbone of that name loads with
``strict=True``.  The names are those that the JAX package's
``reference_*_shape_manifest`` functions emit and that its
``convert_torch_*`` functions read (``utils/torch_interop.py``); the
tables below are copies of theirs.

* S3DG: the ``features.N`` Sequential is the port's ``base.N``; a SepConv
  pair ('STConv3d') stores its spatial conv and BN as ``conv``/``bn`` and
  its temporal ones as ``conv2``/``bn2``, both convs biased (the port's
  ``conv_s``/``bn_s``, ``conv_t``/``bn_t``); a BasicConv3d is ``conv``/``bn``
  in both; the Mixed branches are ``branchK.J`` in both.
* I3D: ``conv3d_1a_7x7``, ``conv3d_2b_1x1``, ``conv3d_2c_3x3`` are stages
  0, 2 and 3; ``mixed_*`` the Mixed stages; a Unit3Dpy's ``conv3d`` and
  ``batch3d`` are the port's ``conv`` and ``bn``; ``branch_0``,
  ``branch_1.{0,1}``, ``branch_2.{0,1}`` and ``branch_3.1`` are
  ``branch0.0``, ``branch1.{0,1}``, ``branch2.{0,1}`` and ``branch3.1``.
* The ResNets (``convert_torch_resnet`` 2D and 3D, ``_resnet2p1d``,
  ``_resnet_i3d``; shortcut type B): the port's modules carry the
  reference's names (``models/resnet2d.py``, ``resnet3d.py``,
  ``resnet2p1d.py``), so the map is the identity.
* BN-Inception and Inception-v3: the names are the port's too, but the
  reference's convs carry a bias feeding straight into their BN, where the
  port's (as the JAX package's) have none.  The bias folds into the BN's
  running mean exactly (``running_mean - bias``; JAX
  ``_convbn2d_fold_bias``): train-mode BN removes any constant shift, and
  eval outputs are the same.  The inverse writes zero biases.

The classifier (S3DG's ``features.18``, I3D's ``conv3d_0c_1x1``, the 2D
nets' and ResNets' ``fc``) is dropped, as the reference's encoder wrapper
drops it, and so are torch BatchNorm's ``num_batches_tracked`` counters,
which the port's BN (flax semantics, a fixed momentum) has no use for.
Names of any other layout pass through unchanged.
:func:`reference_backbone_names` is the inverse: the port's backbone names
(no graph blocks) -> the reference's.

:func:`detect_kind` tells a whole checkpoint's layout by its roots (JAX
``ckpt_convert.detect_kind``): a pretrain wrapper's (``model.``), CMC's two
stacks (``model_1.``, ``model_2.``) or a downstream classifier's
(``base_model.``); :func:`rgb_stack` takes a CMC checkpoint's first (RGB)
stack, as the JAX surgery does.
"""

from __future__ import annotations

from typing import Dict, TypeVar

V = TypeVar("V")

# the stages of S3D's plan (the port's base.N)
S3D_STAGE_INDEX = {
    "mixed_3b": 5, "mixed_3c": 6, "mixed_4b": 8, "mixed_4c": 9, "mixed_4d": 10,
    "mixed_4e": 11, "mixed_4f": 12, "mixed_5b": 14, "mixed_5c": 15,
}
# S3DG: stages whose module is a SepConv pair, and the Mixed branch modules
# that are ('features.N' and 'features.N.branchK.J' paths)
S3DG_SEP_STAGES = (0, 3)
S3DG_SEP_BRANCHES = ("branch1.1", "branch2.1")
S3DG_SEP_FIELDS = {"conv": "conv_s", "bn": "bn_s", "conv2": "conv_t", "bn2": "bn_t"}
S3DG_CLASSIFIER = "features.18."
# I3D: reference module -> the port's stage, and branch paths
I3D_UNITS = {"conv3d_1a_7x7": 0, "conv3d_2b_1x1": 2, "conv3d_2c_3x3": 3}
I3D_BRANCHES = {"branch_0": "branch0.0", "branch_1.0": "branch1.0", "branch_1.1": "branch1.1",
                "branch_2.0": "branch2.0", "branch_2.1": "branch2.1", "branch_3.1": "branch3.1"}
I3D_FIELDS = {"conv3d": "conv", "batch3d": "bn"}
I3D_CLASSIFIER = "conv3d_0c_1x1."
# the ResNets and the 2D Inception nets: the reference's classifier
FC_CLASSIFIER = "fc."
# the reference's first conv of each 2D Inception net
INCEPTION_STEMS = {"bninception": "conv1.conv.", "inception_v3": "Conv2d_1a_3x3.conv."}
LAYOUTS = ("s3dg", "i3d", "resnet", "bninception", "inception_v3")


def layout_of(sd: Dict[str, V]) -> str:
    """'s3dg' (the reference's S3DG names), 'i3d' (its I3D names),
    'resnet' (any ResNet's), 'bninception', 'inception_v3' or 'port'
    (anything else)."""
    if any(k.startswith("features.0.conv2.") for k in sd):
        return "s3dg"
    if any(k.startswith("conv3d_1a_7x7.") for k in sd):
        return "i3d"
    for layout, stem in INCEPTION_STEMS.items():
        if any(k.startswith(stem) for k in sd):
            return layout
    if any(k.startswith("layer1.") for k in sd):
        return "resnet"
    return "port"


def detect_kind(sd: Dict[str, V]) -> str:
    """'pretrain' (``model.`` roots), 'cmc_pretrain' (``model_1.`` and
    ``model_2.``) or 'downstream' (``base_model.``), through a DDP
    ``module.`` prefix; raises for any other layout."""
    roots = {k.split(".")[0] for k in sd}
    if roots == {"module"}:
        roots = {k.split(".")[1] for k in sd}
    if "model" in roots:
        return "pretrain"
    if {"model_1", "model_2"} <= roots:
        return "cmc_pretrain"
    if "base_model" in roots:
        return "downstream"
    raise ValueError(f"unrecognized checkpoint layout; roots={sorted(roots)}")


def rgb_stack(sd: Dict[str, V]) -> Dict[str, V]:
    """A CMC checkpoint's ``model_1`` stack under a pretrain wrapper's names
    (``model.*``; a ``module.`` prefix dropped first)."""
    if all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return {k[len("model_1."):]: v for k, v in sd.items() if k.startswith("model_1.")}


def _s3dg_name(key: str) -> str:
    parts = key.split(".")
    if parts[0] != "features":
        raise KeyError(f"not an S3DG name: {key}")
    idx, rest = int(parts[1]), parts[2:]
    branch = ".".join(rest[:2])
    if idx in S3DG_SEP_STAGES:
        rest = [S3DG_SEP_FIELDS[rest[0]]] + rest[1:]
    elif branch in S3DG_SEP_BRANCHES:
        rest = rest[:2] + [S3DG_SEP_FIELDS[rest[2]]] + rest[3:]
    return ".".join(["base", str(idx)] + rest)


def _i3d_name(key: str) -> str:
    module, *path, field, leaf = key.split(".")
    if module in I3D_UNITS and not path:
        base = f"base.{I3D_UNITS[module]}"
    elif module in S3D_STAGE_INDEX:
        base = f"base.{S3D_STAGE_INDEX[module]}.{I3D_BRANCHES['.'.join(path)]}"
    else:
        raise KeyError(f"not an I3D name: {key}")
    return f"{base}.{I3D_FIELDS[field]}.{leaf}"


def _fold_conv_biases(sd: Dict[str, V]) -> Dict[str, V]:
    """BN-Inception / Inception-v3: each ``X.conv.bias`` folded into
    ``X.bn.running_mean`` and dropped."""
    out = {k: v for k, v in sd.items() if not k.endswith(".conv.bias")}
    for k, bias in sd.items():
        if k.endswith(".conv.bias"):
            mean = k[:-len("conv.bias")] + "bn.running_mean"
            out[mean] = sd[mean] - bias
    return out


def port_backbone_names(sd: Dict[str, V]) -> Dict[str, V]:
    """``sd`` under the port's backbone names: the reference's S3DG or I3D
    names mapped, a ResNet's kept, a 2D Inception net's conv biases folded;
    their classifier and BN counters dropped; any other layout
    unchanged."""
    layout = layout_of(sd)
    if layout == "port":
        return dict(sd)
    if layout not in ("s3dg", "i3d"):
        sd = {k: v for k, v in sd.items()
              if not k.startswith(FC_CLASSIFIER) and not k.endswith(".num_batches_tracked")}
        return sd if layout == "resnet" else _fold_conv_biases(sd)
    name, classifier = ((_s3dg_name, S3DG_CLASSIFIER) if layout == "s3dg"
                        else (_i3d_name, I3D_CLASSIFIER))
    return {name(k): v for k, v in sd.items()
            if not k.startswith(classifier) and not k.endswith(".num_batches_tracked")}


def reference_backbone_names(sd: Dict[str, V], layout: str) -> Dict[str, V]:
    """The port's backbone names (without graph blocks) of ``layout`` (one
    of :data:`LAYOUTS`) -> the reference's: the inverse of
    :func:`port_backbone_names`; BN-Inception's and Inception-v3's convs
    get zero biases."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
    if layout == "resnet":
        return dict(sd)
    if layout in INCEPTION_STEMS:
        out = dict(sd)
        for k, v in sd.items():
            if k.endswith(".conv.weight"):
                out[k[:-len("weight")] + "bias"] = v.new_zeros(v.shape[0])
        return out
    stage_of = {v: k for k, v in S3D_STAGE_INDEX.items()}
    unit_of = {v: k for k, v in I3D_UNITS.items()}
    branch_of = {v: k for k, v in I3D_BRANCHES.items()}
    field_of = {v: k for k, v in (S3DG_SEP_FIELDS if layout == "s3dg" else I3D_FIELDS).items()}
    out = {}
    for key, v in sd.items():
        base, idx, *rest = key.split(".")
        if base != "base":
            raise KeyError(f"not a port backbone name: {key}")
        if layout == "s3dg":
            rest = [field_of.get(r, r) for r in rest]
            out[".".join(["features", idx] + rest)] = v
        else:
            *path, field, leaf = rest
            module = (unit_of[int(idx)] if not path
                      else f"{stage_of[int(idx)]}.{branch_of['.'.join(path)]}")
            out[f"{module}.{field_of[field]}.{leaf}"] = v
    return out
