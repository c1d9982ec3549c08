"""Whole reference checkpoints -> the port's checkpoints, and back
(counterpart of the graft and export half of
``video_graph_ssl_tpu/utils/ckpt_convert.py``).

A reference training checkpoint (``torch.save`` of ``{'epoch', 'state_dict',
'optimizer', 'contrast', ['model_ema']}``, the reference's
tools/train_video_contrast_dis.py:274-283, or a downstream
``VideoModelWrapper`` state_dict) becomes a file of
``utils/checkpoint.py``'s format that every tool of the port takes.  The
state dicts are rooted as the reference roots them: ``model.*`` (a pretrain
``GraphWrapper``: ``model.encoder.base_model.*`` and the heads), ``model_1.*``
and ``model_2.*`` (CMC's two stacks), or ``base_model.*`` and ``new_fc.*``
(downstream), through a DDP ``module.`` prefix.

Names: the port's heads, wrappers and ResNets carry the reference's names;
the backbones' names map through ``utils/torch_names.py`` (S3DG's and I3D's
module paths, BN-Inception's and Inception-v3's conv biases folded into the
BN means); torch BN's ``num_batches_tracked`` counters and the backbone's
classifier are dropped.  A graph block wraps its S3D stage as
``Sequential(graph, stage)``: the stage's names move to ``base.N.1.*`` and
the block's are ``base.N.0.*``, the only wraps that JAX's
``split_aug_wrapped_sd`` reads; a state dict of any other backbone that
holds graph blocks is refused, as no converter defines its layout.

The backbones are those that JAX's converter covers
(:data:`CONVERTED`); any other is refused with JAX's message, and
``i3d_res50_nonlocal`` with JAX's reason too.  The memory (the reference's
``memory``, CMC's ``memory_1``/``memory_2``) becomes the port's queue or
bank where the shapes agree; the EMA encoder is converted, or copied from
the model where the payload has none (the reference's init); the
optimizer is re-initialised.  Each of these is recorded in the notes.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from ..memory.build import contrast_fields
from ..models.s3d import stem_params_to_s2d
from .torch_names import port_backbone_names, reference_backbone_names

# the backbones JAX's converter covers (JAX utils/ckpt_convert.py
# _BACKBONE_CONVERTERS, by lower-case name)
CONVERTED = ("s3d", "s3dg", "i3d", "inceptioni3d", "bninception", "inception_v3",
             *(f"resnet3d_{d}" for d in (10, 18, 34, 50, 101, 152, 200)),
             *(f"resnet{d}" for d in (18, 34, 50, 101, 152)),
             *(f"resnet2p1d_{d}" for d in (10, 18, 34, 50, 101, 152, 200)),
             *(f"resnet_i3d_{d}" for d in (18, 34, 50, 101)))
# JAX i3dnon.py:29-33
NONLOCAL_REASON = ("a reference i3d_res50_nonlocal checkpoint contains neither the non-local "
                   "weights (its nonlocalnet builds a fresh block at every call) nor 5 of "
                   "layer3's 6 blocks (_make_layer_inflat builds one), so it has no "
                   "counterpart of the network that the port and JAX train")
GRAPH_FIELDS = ("g_q", "g_k", "gcns")
ENCODER = {"pretrain": "model.encoder.base_model.", "downstream": "base_model."}
CMC_STACKS = ("model_1", "model_2")
COUNTER = ".num_batches_tracked"
# the classifier of a reference S3D (s3d_1.py's fc.0, a 1x1x1 conv)
S3D_CLASSIFIER = "fc."

SD = Dict[str, Any]


def layout(backbone: str) -> str:
    """The reference layout of ``backbone``'s names: 's3d' (the port's are
    the reference's ``base.N``), or one of ``torch_names.LAYOUTS``; raises
    JAX's NotImplementedError for a backbone its converter does not
    cover."""
    name = backbone.lower()
    if name not in CONVERTED:
        reason = f"; {NONLOCAL_REASON}" if name == "i3d_res50_nonlocal" else ""
        raise NotImplementedError(f"no torch converter for backbone '{name}' "
                                  f"(have: {sorted(CONVERTED)}){reason}")
    if name in ("s3d", "s3dg", "i3d", "bninception", "inception_v3"):
        return name
    return "i3d" if name == "inceptioni3d" else "resnet"


def _graph_field(k: str) -> bool:
    return any(part in GRAPH_FIELDS for part in k.split("."))


def split_graphs(sd: SD) -> Tuple[SD, Dict[int, SD]]:
    """(the S3D names with each wrapped stage's ``base.N.1.`` back to
    ``base.N.``, {N: its graph block's names}), as JAX's
    ``split_aug_wrapped_sd``; a state dict without wraps passes through."""
    wrapped = {int(k.split(".")[1]) for k in sd
               if k.startswith("base.") and k.split(".")[2] == "0" and _graph_field(k)}
    clean: SD = {}
    graphs: Dict[int, SD] = {i: {} for i in wrapped}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] == "base" and len(parts) > 2 and parts[1] in map(str, wrapped):
            if parts[2] == "0":
                graphs[int(parts[1])][".".join(parts[3:])] = v
                continue
            if parts[2] == "1":
                clean[".".join(parts[:2] + parts[3:])] = v
                continue
        clean[k] = v
    return clean, graphs


def wrap_graphs(sd: SD, graphs: Dict[int, SD]) -> SD:
    """The inverse of :func:`split_graphs`."""
    out = dict(sd)
    for i, graph in graphs.items():
        p = f"base.{i}"
        for k in [k for k in out if k.startswith(p + ".")]:
            out[f"{p}.1.{k[len(p) + 1:]}"] = out.pop(k)
        out.update({f"{p}.0.{k}": v for k, v in graph.items()})
    return out


def _refuse_graphs(enc: SD, backbone: str) -> None:
    """Graph blocks are converted on S3D only (JAX's converter reads
    ``base.N.0`` wraps alone)."""
    if any(_graph_field(k) for k in enc):
        raise NotImplementedError(
            f"graph blocks (MODEL.AUG_FLAG) are converted for S3D only: no converter "
            f"defines the reference layout of a graph-wrapped '{backbone.lower()}'")


def _stem_mode(stem_s2d) -> str:
    """JAX ``convert_torch_s3d``'s ``stem_s2d``: False/'' (off), True or
    'full', 'spatial'."""
    if not stem_s2d:
        return ""
    return "spatial" if stem_s2d == "spatial" else "full"


def port_encoder(enc: SD, backbone: str, stem_s2d=False) -> SD:
    """A reference backbone's state dict (S3D's graph wraps included) ->
    the port's names, the classifier and BN counters dropped.  ``stem_s2d``
    (JAX ``convert_torch_s3d(stem_s2d=...)``: True/'full' or 'spatial')
    folds the S3D/S3DG stem for the space-to-depth stem
    (``models/s3d.py:stem_params_to_s2d``)."""
    lay = layout(backbone)
    mode = _stem_mode(stem_s2d)
    if mode and lay not in ("s3d", "s3dg"):
        raise ValueError(f"stem_s2d only applies to S3D/S3DG, got {backbone}")
    enc = {k: v for k, v in enc.items() if not k.endswith(COUNTER)}
    if lay != "s3d":
        _refuse_graphs(enc, backbone)
        out = port_backbone_names(enc)
    else:
        clean, graphs = split_graphs(enc)
        clean = {k: v for k, v in clean.items() if not k.startswith(S3D_CLASSIFIER)}
        out = wrap_graphs(clean, graphs)
    return stem_params_to_s2d(out, mode) if mode else out


def _refuse_folded_stem(enc: SD) -> None:
    """JAX's export has no unfold: a space-to-depth stem has no reference
    names."""
    for k, v in enc.items():   # no other S3D conv has a (1, 4, 4) window
        if k.endswith("conv_s.weight") and tuple(v.shape[-3:]) == (1, 4, 4):
            raise ValueError(f"{k} is a folded space-to-depth stem (TPU.STEM_S2D): the "
                             "reference has no such stem and no unfold is defined")


def reference_encoder(enc: SD, backbone: str) -> SD:
    """The port's backbone names -> the reference's (the inverse of
    :func:`port_encoder` without ``stem_s2d``; a folded stem is refused)."""
    lay = layout(backbone)
    _refuse_folded_stem(enc)
    if lay == "s3d":
        return dict(enc)
    _refuse_graphs(enc, backbone)
    return reference_backbone_names(enc, lay)


def _strip(sd: SD) -> SD:
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return {k: v for k, v in sd.items() if not k.endswith(COUNTER)}


def _under(sd: SD, prefix: str) -> SD:
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not out:
        raise KeyError(f"no keys under '{prefix}' — got roots "
                       f"{sorted({k.split('.')[0] for k in sd})}")
    return out


def _convert(sd: SD, backbone: str, kind: str, encoder_fn) -> SD:
    if kind == "cmc_pretrain":
        return {f"{st}.{k}": v for st in CMC_STACKS
                for k, v in _convert(_under(sd, st + "."), backbone, "pretrain",
                                     encoder_fn).items()}
    prefix = ENCODER[kind]
    enc = encoder_fn(_under(sd, prefix), backbone)
    out = {k: v for k, v in sd.items() if not k.startswith(prefix)}
    out.update({prefix + k: v for k, v in enc.items()})
    return out


def port_state_dict(sd: SD, backbone: str, kind: str, stem_s2d=False) -> SD:
    """A reference state dict of ``kind`` ('pretrain', 'cmc_pretrain' or
    'downstream') -> the port's model's names (``module.`` and the BN
    counters dropped; the stem folded with ``stem_s2d``)."""
    return _convert(_strip(sd), backbone, kind,
                    functools.partial(port_encoder, stem_s2d=stem_s2d))


def reference_state_dict(sd: SD, backbone: str, kind: str) -> SD:
    """The port's model's state dict of ``kind`` -> the reference's names."""
    return _convert(dict(sd), backbone, kind, reference_encoder)


def _tensors(sd: SD) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def _memory_map(fields) -> Dict[str, str]:
    """The reference's memory buffers -> the port's contrast fields."""
    if "queue_1" in fields or "memory_1" in fields:
        ours = "queue" if "queue_1" in fields else "memory"
        return {"memory_1": f"{ours}_1", "memory_2": f"{ours}_2"}
    return {"memory": "queue" if "queue" in fields else "memory"}


def graft_pretrain(state, payload: Dict[str, Any], backbone: str, cmc: bool,
                   stem_s2d=False) -> Dict[str, str]:
    """Load a reference pretrain payload into the live ``PretrainState``
    (strict names): the model, the EMA encoder (converted, or copied from
    the model), the memory where its shape agrees; returns the notes.
    ``stem_s2d`` folds the stem (:func:`port_encoder`)."""
    kind = "cmc_pretrain" if cmc else "pretrain"
    notes = {"optimizer": "reinitialized"}
    state.model.load_state_dict(_tensors(port_state_dict(payload["state_dict"], backbone,
                                                         kind, stem_s2d)), strict=True)
    if state.ema_model is not None:
        ema = payload.get("model_ema")
        if ema is not None:
            state.ema_model.load_state_dict(
                _tensors(port_state_dict(ema, backbone, kind, stem_s2d)), strict=True)
            notes["model_ema"] = "converted"
        else:
            # the reference starts the EMA encoder as a copy
            # (train_video_contrast_dis.py:145-146)
            state.ema_model.load_state_dict(state.model.state_dict(), strict=True)
            notes["model_ema"] = "copied from model (absent in source)"
    source = payload.get("contrast") or {}
    if state.contrast is None or not source:
        return notes
    fields = contrast_fields(state.contrast)
    done = []
    for src, dst in _memory_map(fields).items():
        if src not in source:
            notes["contrast"] = (f"kept template init (no '{src}' buffer in source: "
                                 f"{sorted(source)})")
            return notes
        mem, tmpl = torch.as_tensor(source[src]), fields[dst]
        if tuple(mem.shape) != tuple(tmpl.shape):
            notes["contrast"] = (f"kept template init (shape mismatch: ours "
                                 f"{tuple(tmpl.shape)} vs source {tuple(mem.shape)})")
            return notes
        done.append((tmpl, mem, f"'{src}' -> {dst}"))
    for tmpl, mem, _ in done:
        tmpl.copy_(mem)
    notes["contrast"] = "converted (" + ", ".join(d for _, _, d in done) + ")"
    return notes


def graft_downstream(state, payload: Dict[str, Any], backbone: str,
                     stem_s2d=False) -> Dict[str, str]:
    """Load a reference downstream payload into the live downstream state
    (strict names; the stem folded with ``stem_s2d``); returns the notes."""
    state.model.load_state_dict(_tensors(port_state_dict(payload["state_dict"], backbone,
                                                         "downstream", stem_s2d)),
                                strict=True)
    return {"optimizer": "reinitialized"}


def export_payload(payload: Dict[str, Any], backbone: str) -> Dict[str, Any]:
    """A port checkpoint's payload -> the reference's: ``epoch``,
    ``state_dict`` (and ``model_ema``) under the reference's names, the
    memory as ``contrast`` (``memory``; CMC's ``memory_1``, ``memory_2``)."""
    from .torch_names import detect_kind

    kind = detect_kind(payload["state_dict"])
    out = {"epoch": int(payload.get("epoch", 0)),
           "state_dict": reference_state_dict(payload["state_dict"], backbone, kind)}
    if payload.get("model_ema") is not None:
        out["model_ema"] = reference_state_dict(payload["model_ema"], backbone, kind)
    contrast = payload.get("contrast")
    if contrast:
        out["contrast"] = {src: contrast[dst] for src, dst in _memory_map(contrast).items()}
    return out
