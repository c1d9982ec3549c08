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
``model_ema``; :func:`load_checkpoint_state` restores it.

The sharded backend (``TPU.CKPT_BACKEND orbax``, JAX's orbax directories):
:func:`save_checkpoint_orbax` writes the same payload as a
``torch.distributed.checkpoint`` directory, ``<name>.dcp`` (the suffix
names the format, as JAX's ``.orbax`` names orbax's and ``.pth.tar``
stands for ``.msgpack``; ``torch.load`` does not read it), with the same
``.meta.json`` beside it.  Every rank of a process group calls it: each
tensor of the replicated state is written once, by one rank, so the ranks
share the writing.  The payload's structure (nested dicts, the
optimizer's integer keys, scalars) is kept as JSON in the directory's
``__skeleton__`` entry (a uint8 tensor), each tensor under its path.
``async_save`` (``TPU.ASYNC_CKPT``) goes through ``dcp.async_save``, which
stages the state in host memory at the call and writes in the background: at most
one save is in flight, the next save and the process's exit drain it
(:func:`wait_for_async_checkpoints`), as JAX's contract.  A directory loads
in any number of processes (each rank reads the whole state, which is
replicated), so one written by 2 ranks loads in 1 process or on 2 ranks bit
for bit (:func:`load_checkpoint_orbax`; :func:`load_checkpoint_any` and
:func:`read_payload` dispatch on a directory).  A directory that JAX's
orbax wrote is not read: that would take orbax, which imports JAX.
:func:`transfer_encoder_params` is the SSL -> downstream surgery (JAX
``load_params_only`` + ``transfer_encoder_params``); from a CMC checkpoint it
takes ``model_1``'s (the RGB stack's) encoder, as JAX does.
"""

from __future__ import annotations

import atexit
import json
import os
from typing import Any, Dict, List, Optional

import torch

from ..memory.build import contrast_fields
from ..parallel import dist

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


DCP_SUFFIX = ".dcp"
SKELETON = "__skeleton__"
# async saves in flight (at most one)
_ASYNC_SAVES: list = []


def _flatten(obj: Any, path: str, tensors: Dict[str, torch.Tensor]) -> Any:
    """``obj`` as JSON with each tensor replaced by its path in ``tensors``."""
    if isinstance(obj, torch.Tensor):
        tensors[path] = obj
        return {"t": path}
    if isinstance(obj, dict):
        return {"d": [[k, _flatten(v, f"{path}/{k}", tensors)] for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        kind = "l" if isinstance(obj, list) else "u"
        return {kind: [_flatten(v, f"{path}/{i}", tensors) for i, v in enumerate(obj)]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"v": obj}
    raise TypeError(f"checkpoint entry {path}: cannot store a {type(obj).__name__}")


def _unflatten(skel: Any, tensors: Dict[str, torch.Tensor]) -> Any:
    (kind, v), = skel.items()
    if kind == "t":
        return tensors[v]
    if kind == "d":
        return {k: _unflatten(x, tensors) for k, x in v}
    if kind in ("l", "u"):
        items = [_unflatten(x, tensors) for x in v]
        return items if kind == "l" else tuple(items)
    return v


def wait_for_async_checkpoints() -> None:
    """Block until every in-flight async save has committed."""
    while _ASYNC_SAVES:
        _ASYNC_SAVES.pop().result()


# a save still in flight commits before the interpreter exits
atexit.register(wait_for_async_checkpoints)


def save_checkpoint_orbax(path: str, state, epoch: int, best_pred: float = 0.0,
                          extra: Optional[Dict[str, Any]] = None, async_save: bool = False,
                          process_group=None) -> None:
    """Write the checkpoint to the ``path`` directory (the sharded backend,
    JAX ``save_checkpoint_orbax``; every rank of the group calls it) and
    rank 0 its ``.meta.json``.  ``async_save`` returns once
    ``dcp.async_save`` has staged the state in host memory (its snapshot at
    the call); the write commits in the background."""
    import torch.distributed.checkpoint as dcp

    payload = checkpoint_payload(state, epoch, best_pred)
    payload["meta"] = {**{k: payload[k] for k in META_KEYS}, **(extra or {})}
    path = os.path.abspath(path)
    tensors: Dict[str, torch.Tensor] = {}
    skel = json.dumps(_flatten(payload, "", tensors)).encode()
    if async_save:
        wait_for_async_checkpoints()     # at most one save in flight
    tensors[SKELETON] = torch.frombuffer(bytearray(skel), dtype=torch.uint8)
    kw = dict(checkpoint_id=path, process_group=process_group,
              no_dist=dist.world_size() == 1)
    if async_save:
        _ASYNC_SAVES.append(dcp.async_save(tensors, **kw))
    else:
        dcp.save(tensors, **kw)
    if dist.is_main():
        with open(path + ".meta.json", "w") as f:
            json.dump(payload["meta"], f)


def _read_dcp(path: str, map_location) -> Dict[str, Any]:
    """A directory of :func:`save_checkpoint_orbax` as its payload dict, its
    tensors on ``map_location``; read whole by this process alone."""
    import torch.distributed.checkpoint as dcp

    reader = dcp.FileSystemReader(path)
    meta = reader.read_metadata().state_dict_metadata
    tensors = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
               for k, m in meta.items()}
    dcp.load(tensors, storage_reader=reader, no_dist=True)
    skel = json.loads(tensors.pop(SKELETON).numpy().tobytes().decode())
    tensors = {k: v.to(map_location) for k, v in tensors.items()}
    return _unflatten(skel, tensors)


def read_payload(path: str, map_location="cpu") -> Dict[str, Any]:
    """A checkpoint's payload dict: a sharded-backend directory or a
    ``torch.save`` file (JAX ``load_checkpoint_any``'s dispatch)."""
    if os.path.isdir(path):
        return _read_dcp(path, map_location)
    return torch.load(path, map_location=map_location, weights_only=True)


def load_checkpoint_state(path: str, state) -> Dict[str, Any]:
    """Restore a checkpoint (a file, or a sharded-backend directory) into
    the live ``PretrainState`` on its device (strict names); returns the
    metadata."""
    device = next(state.model.parameters()).device
    return restore_payload(state, read_payload(path, device), path)


def restore_payload(state, payload: Dict[str, Any], what: str = "checkpoint") -> Dict[str, Any]:
    """Restore a checkpoint's payload dict (:func:`checkpoint_payload`'s
    layout) into the live ``PretrainState`` (strict names); returns its
    ``meta`` (empty where it has none).  ``what`` names the source in
    errors."""
    for part, present in (("model_ema", state.ema_model is not None),
                          ("contrast", state.contrast is not None)):
        if (part in payload) != present:
            raise KeyError(f"checkpoint {what}: '{part}' is "
                           f"{'missing' if present else 'present'}, which does not fit "
                           "the configured CONTRAST.MEM_TYPE")
    state.model.load_state_dict(payload["state_dict"], strict=True)
    if state.ema_model is not None:
        state.ema_model.load_state_dict(payload["model_ema"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    contrast = payload.get("contrast")
    if contrast is not None:
        restore_contrast(state.contrast, contrast, what)
    state.step = int(payload["step"])
    state.seed = int(payload["seed"])
    return payload.get("meta", {})


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


# JAX's names for the two readers (a directory or a file either way)
load_checkpoint_orbax = load_checkpoint_any = load_checkpoint_state


def load_params_only(path: str):
    """(state_dict, meta) of a checkpoint (a file or a directory) on the
    CPU, for surgery."""
    payload = read_payload(path)
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
