"""Convert reference (PyTorch) training checkpoints to the port's, and back
(counterpart of ``tools/convert_checkpoint.py``).

A user of the reference moves over by converting a ``.pth.tar`` once; the
output is a checkpoint in ``utils/checkpoint.py``'s format, which
``train_ds --ssl_checkpoint``, ``test_ds --checkpoint``,
``video_retrieval --checkpoint`` and the trainer's ``CHECKPOINT.RESUME``
take as they take their own::

    # reference SSL pretrain checkpoint -> the port's
    python -m video_graph_ssl_tpu_torch.convert_checkpoint \\
        --config_file configs/visual_moco.yaml \\
        --torch_ckpt gca_moco_ep200.pth.tar --output gca_moco_ep200_port.pth.tar
    python -m video_graph_ssl_tpu_torch.train_ds --config_file configs/action_fine_tune.yaml \\
        --ssl_checkpoint gca_moco_ep200_port.pth.tar

    # a reference downstream checkpoint -> the port's (evaluate with test_ds)
    python -m video_graph_ssl_tpu_torch.convert_checkpoint \\
        --config_file configs/action_fine_tune.yaml \\
        --torch_ckpt ucf_finetune.pth.tar --output ucf_finetune_port.pth.tar

    # the port's checkpoint -> the reference's names (pretrain, CMC or
    # downstream, by the checkpoint's roots)
    python -m video_graph_ssl_tpu_torch.convert_checkpoint \\
        --config_file configs/visual_moco.yaml \\
        --checkpoint port.pth.tar --to_torch reference_named.pth.tar

What converts: the weights and BN statistics of the backbone (every
backbone JAX's converter covers: ``utils/ckpt_convert.py``) and the heads,
the MoCo queue or the bank (its row count taken from the payload), the EMA
encoder (copied from the model where the payload has none) and the epoch.
The optimizer is re-initialised (the reference's SGD buffers are not
carried); the checkpoint's metadata says so.  ``--what`` picks the
payload's kind (default: by its roots).  ``--device`` is where the state is
built (default ``cuda``, which raises when there is no GPU).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from .engine.build import create_downstream_state, create_pretrain_state
from .models.build import create_video_model, create_visual_model, is_cmc, stem_s2d_mode
from .train_video_contrast_dis import load_config, resolve_device
from .utils.checkpoint import read_payload, save_checkpoint_state
from .utils.ckpt_convert import export_payload, graft_downstream, graft_pretrain
from .utils.torch_names import detect_kind


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Reference checkpoint converter (PyTorch port)")
    p.add_argument("--config_file", default="", type=str,
                   help="config matching the checkpoint's architecture")
    p.add_argument("--torch_ckpt", default="", type=str,
                   help="reference .pth/.pth.tar to convert to the port's format")
    p.add_argument("--output", default="", type=str,
                   help="output path (with --torch_ckpt; default <torch_ckpt>_port.pth.tar)")
    p.add_argument("--what", default="auto",
                   choices=["auto", "pretrain", "cmc_pretrain", "downstream"])
    p.add_argument("--checkpoint", default="", type=str,
                   help="the port's checkpoint (with --to_torch)")
    p.add_argument("--to_torch", default="", type=str,
                   help="output .pth.tar with the reference's names")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device the state is built on (default: cuda)")
    p.add_argument("opts", nargs="*", help="config overrides: KEY VALUE ...")
    return p


def load_payload(path: str) -> dict:
    """A reference checkpoint as ``{'state_dict': ..., ...}`` (a bare state
    dict is wrapped)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        return obj
    return {"state_dict": obj}


def default_output(torch_ckpt: str) -> str:
    """``<name>_port.pth.tar`` beside ``<name>.pth.tar`` (or ``.pth``)."""
    for suffix in (".pth.tar", ".pth", ".tar"):
        if torch_ckpt.endswith(suffix):
            return torch_ckpt[:-len(suffix)] + "_port.pth.tar"
    return torch_ckpt + "_port.pth.tar"


def convert_to_port(args, cfg) -> str:
    payload = load_payload(args.torch_ckpt)
    kind = args.what
    if kind == "auto":
        kind = detect_kind(payload["state_dict"])
        print(f"=> detected checkpoint kind: {kind}")
    if kind == "cmc_pretrain" and not is_cmc(cfg):
        raise ValueError("checkpoint has two CMC stacks (model_1/model_2) but the config "
                         "has CROSS.MODALITY=visual — pass the CMC config/overrides")
    device = resolve_device(args.device)
    backbone = str(cfg.MODEL.BACKBONE)
    # a TPU.STEM_S2D model takes the reference's stem folded
    s2d = stem_s2d_mode(cfg, backbone)
    if kind in ("pretrain", "cmc_pretrain"):
        model, _ = create_visual_model(cfg)
        memory = payload.get("contrast") or {}
        # the bank: one row per dataset sample (CMC: memory_1/memory_2)
        n_data = next((int(torch.as_tensor(memory[m]).shape[0])
                       for m in ("memory", "memory_1") if m in memory), 1)
        state = create_pretrain_state(cfg, model, device, n_data=n_data)
        with torch.no_grad():
            notes = graft_pretrain(state, payload, backbone, kind == "cmc_pretrain", s2d)
    else:
        model, _ = create_video_model(cfg)
        state = create_downstream_state(cfg, model, device)
        with torch.no_grad():
            notes = graft_downstream(state, payload, backbone, s2d)
    epoch = int(payload.get("epoch", 0))
    out = args.output or default_output(args.torch_ckpt)
    save_checkpoint_state(out, state, epoch, extra={
        "converted_from": os.path.basename(args.torch_ckpt), **notes})
    print(f"=> wrote '{out}' (epoch {epoch})")
    for k, v in notes.items():
        print(f"   {k}: {v}")
    return out


def convert_to_reference(args, cfg) -> str:
    payload = read_payload(args.checkpoint)
    out = export_payload(payload, str(cfg.MODEL.BACKBONE))
    torch.save(out, args.to_torch)
    print(f"=> wrote '{args.to_torch}' ({len(out['state_dict'])} tensors, "
          f"epoch {out['epoch']})")
    return args.to_torch


def main(argv: Optional[list] = None) -> str:
    args = get_parser().parse_intermixed_args(argv)
    cfg = load_config(args.config_file, args.opts)
    if args.torch_ckpt:
        return convert_to_port(args, cfg)
    if args.checkpoint and args.to_torch:
        return convert_to_reference(args, cfg)
    raise SystemExit("pass --torch_ckpt (to the port's format) or --checkpoint + --to_torch "
                     "(to the reference's names)")


if __name__ == "__main__":
    main()
