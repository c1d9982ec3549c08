"""Checkpoints of the pretrain state (counterpart of the msgpack path of
``video_graph_ssl_tpu/utils/checkpoint.py``: ``save_checkpoint_state`` and
``load_checkpoint_state``).

A checkpoint is one ``torch.save`` file holding a dict in the reference's
layout (lib/utils/saver.py:20-43, tools/train_video_contrast_dis.py:271-287):
``epoch``, ``state_dict`` (parameters and BN statistics, reference names),
``optimizer`` (the SGD momentum buffers), ``contrast`` (the MoCo queue and
ptr, or the bank's ``memory``; CMC's ``queue_1``, ``queue_2`` and ``ptr``, or
``memory_1`` and ``memory_2``, JAX's names; none for SimSiam), ``model_ema``
(MoCo only) and ``best_pred``; plus ``step`` and ``seed``, from which
:meth:`PretrainState.step_seed` derives each step's graph and augmentation
seeds, so a resumed run continues the same random streams.  The metadata
(``epoch``, ``best_pred``, ``step`` and any extra keys) is also written to
``<path>.meta.json``, as in the JAX package.

Under several ranks the state is replicated, so one file holds it: the
``Saver`` writes it from rank 0 while the other ranks wait at a barrier,
and every rank loads it on resume.

A downstream checkpoint is the same file over a ``VideoModel``: its
``state_dict`` has the reference ``VideoModelWrapper``'s names
(``base_model.*``, ``new_fc.*``) and it holds no ``contrast`` and no
``model_ema``; :func:`load_checkpoint_state` restores it (JAX
``load_checkpoint_any``: the port writes single files only).
:func:`transfer_encoder_params` is the SSL -> downstream surgery (JAX
``load_params_only`` + ``transfer_encoder_params``); from a CMC checkpoint it
takes ``model_1``'s (the RGB stack's) encoder, as JAX does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import torch

from ..memory.build import contrast_fields

META_KEYS = ("epoch", "best_pred", "step")
SSL_ENCODER = "model.encoder.base_model."
# the RGB stack's encoder in a CMC checkpoint
CMC_ENCODER = "model_1." + SSL_ENCODER


def _contrast(contrast) -> Optional[Dict[str, Any]]:
    if contrast is None:
        return None
    return {k: int(v) if k == "ptr" else v for k, v in contrast_fields(contrast).items()}


def checkpoint_payload(state, epoch: int, best_pred: float = 0.0) -> Dict[str, Any]:
    """The live state as the checkpoint dict (tensors are the state's own,
    on its device); ``contrast`` and ``model_ema`` only where the regime
    has them."""
    payload = {
        "epoch": int(epoch),
        "state_dict": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "best_pred": float(best_pred),
        "step": int(state.step),
        "seed": int(state.seed),
    }
    contrast = _contrast(state.contrast)
    if contrast is not None:
        payload["contrast"] = contrast
    if state.ema_model is not None:
        payload["model_ema"] = state.ema_model.state_dict()
    return payload


def save_checkpoint_state(path: str, state, epoch: int, best_pred: float = 0.0,
                          extra: Optional[Dict[str, Any]] = None) -> None:
    """Write the checkpoint to ``path`` (through a temporary file and a
    rename, so a preempted write never leaves a torn file) and its
    ``.meta.json``."""
    payload = checkpoint_payload(state, epoch, best_pred)
    payload["meta"] = {**{k: payload[k] for k in META_KEYS}, **(extra or {})}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    with open(path + ".meta.json", "w") as f:
        json.dump(payload["meta"], f)


def load_checkpoint_state(path: str, state) -> Dict[str, Any]:
    """Restore a checkpoint into the live ``PretrainState`` on its device
    (strict names); returns the metadata."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    for part, present in (("model_ema", state.ema_model is not None),
                          ("contrast", state.contrast is not None)):
        if (part in payload) != present:
            raise KeyError(f"checkpoint {path}: '{part}' is "
                           f"{'missing' if present else 'present'}, which does not fit "
                           "the configured CONTRAST.MEM_TYPE")
    state.model.load_state_dict(payload["state_dict"], strict=True)
    if state.ema_model is not None:
        state.ema_model.load_state_dict(payload["model_ema"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    contrast = payload.get("contrast")
    if contrast is not None:
        restore_contrast(state.contrast, contrast, path)
    state.step = int(payload["step"])
    state.seed = int(payload["seed"])
    return payload["meta"]


def restore_contrast(live, saved: Dict[str, Any], what: str) -> None:
    """Copy a saved memory (JAX's field names) into the live one, in place;
    the field names must match (a CMC memory does not take a visual one)."""
    fields = contrast_fields(live)
    if set(saved) != set(fields):
        raise KeyError(f"{what}: contrast holds {sorted(saved)}, the configured memory "
                       f"{sorted(fields)}")
    for name, v in fields.items():
        if name == "ptr":
            live.ptr = int(saved[name])
        else:
            v.copy_(torch.as_tensor(saved[name]))


def load_params_only(path: str):
    """(state_dict, meta) of a checkpoint on the CPU, for surgery."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["state_dict"], payload.get("meta", {})


def transfer_encoder_params(ssl_state_dict: Dict[str, torch.Tensor], model) -> None:
    """Checkpoint surgery: load the encoder of a port pretrain checkpoint's
    ``state_dict`` (MoCo, SimSiam or bank: ``model.encoder.base_model.*``;
    CMC: ``model_1``'s, ``model_1.model.encoder.base_model.*``) into
    ``model``'s ``base_model``, strictly, keeping its fresh ``new_fc``; the
    projection heads and CMC's second stack are dropped (the checkpoint's
    EMA encoder and memory are not in its ``state_dict``)."""
    prefix = (CMC_ENCODER if any(k.startswith("model_1.") for k in ssl_state_dict)
              else SSL_ENCODER)
    enc = {k[len(prefix):]: v for k, v in ssl_state_dict.items() if k.startswith(prefix)}
    if not enc:
        raise KeyError(f"no '{prefix}*' entries: not a pretrain checkpoint")
    model.base_model.load_state_dict(enc, strict=True)


def mismatches(a: Any, b: Any, prefix: str = "") -> List[str]:
    """Paths at which two checkpoint dicts differ: tensors by value, dtype
    and shape (bit for bit), everything else by ``==``."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{prefix or '.'}: keys {sorted(set(a) ^ set(b), key=str)}"]
        return [m for k in a for m in mismatches(a[k], b[k], f"{prefix}.{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{prefix}: lengths {len(a)} != {len(b)}"]
        return [m for i, (x, y) in enumerate(zip(a, b))
                for m in mismatches(x, y, f"{prefix}[{i}]")]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        same = (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b.to(a.device)))
        return [] if same else [prefix]
    return [] if a == b else [prefix]
