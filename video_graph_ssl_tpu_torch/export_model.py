"""Export a trained model as a ``torch.export`` artifact -- the port's
counterpart of ``tools/export_model.py``::

    python -m video_graph_ssl_tpu_torch.export_model --config_file configs/visual_moco.yaml \\
        --checkpoint run/.../checkpoint_N.pth.tar --what encoder --output export/ \\
        [--batch B | --poly] [--skip_validate] [--device cuda] [KEY VALUE ...]
    python -m video_graph_ssl_tpu_torch.export_model --config_file configs/action_fine_tune.yaml \\
        --checkpoint run/.../model_best_state.pth.tar --what classifier --output export/

The artifact is the whole inference function: a uint8 (B, T, H, W, 3)
canvas at ``INPUT.SCALE_SIZE`` -> centre crop to ``INPUT.BASE_SIZE`` and
mean/std normalisation (``data/transforms_device.py:multi_crop_eval``, one
crop) -> the encoder's features (``--what encoder``: a pretrain checkpoint
of the port, projection head dropped) or the classifier's logits
(``--what classifier``: a downstream checkpoint), in eval mode, with the
weights inside.  ``--batch`` fixes the batch; ``--poly`` exports a
symbolic one (``torch.export.Dim("b")``, up to ``BATCH_MAX``).  It writes
``{what}.pt2`` and ``{what}.manifest.json`` (JAX's keys, with
``torch_version`` and ``device`` in place of ``jax_version`` and
``platforms``), then loads the file back and checks it against the live
model on random frames: max |live - artifact| < 1e-4, as the JAX tool
asserts.

The graph blocks run in eval mode: the adjacency (K1, sampling off) and the
GCN propagation (K2) stay in the exported graph as the operators
``vgs_torch::graph_adjacency`` and ``vgs_torch::gcn_propagate``, and a
CUDA export's max pools as ``vgs_torch::max_pool3d_fwd``.  So a serving
process registers them before it loads the artifact (JAX's StableHLO
artifact needs no model code; this one needs the port's ops)::

    import torch
    import video_graph_ssl_tpu_torch.ops   # registers the port's operators
    fn = torch.export.load("export/encoder.pt2").module()
    feats = fn(frames_uint8)               # on the device of the export

``--device`` defaults to ``cuda`` (the kernels; the artifact runs on the
card) and raises when no GPU is present; ``--device cpu`` exports the plain
versions for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .data.transforms_device import multi_crop_eval
from .models.build import create_video_model, create_visual_model
from .models.layers import place
from .train_video_contrast_dis import load_config, resolve_device
from .utils.checkpoint import load_params_only

TOL_VALIDATE = 1e-4
# the largest symbolic batch: CUDA's launch grids cap one of the exported
# graph's batch dimensions at 65,535 (torch.export refuses an unbounded one
# on the card)
BATCH_MAX = 65535


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Model export (torch.export, PyTorch port)")
    p.add_argument("--config_file", default="", type=str)
    p.add_argument("--checkpoint", default="", type=str, required=True)
    p.add_argument("--what", default="encoder", choices=["encoder", "classifier"])
    p.add_argument("--output", default="export", type=str)
    p.add_argument("--batch", default=1, type=int,
                   help="fixed batch size baked into the artifact; use --poly for a "
                        "symbolic batch dimension")
    p.add_argument("--poly", action="store_true",
                   help="export with a symbolic batch dim")
    p.add_argument("--skip_validate", action="store_true")
    p.add_argument("--device", default="cuda", type=str)
    p.add_argument("opts", nargs="*", help="config overrides: KEY VALUE ...")
    return p


class InferFn(nn.Module):
    """raw uint8 (B, T, H, W, C) at ``scale_hw`` -> (B, D) fp32: one centre
    crop to ``crop_hw``, normalised, through ``model`` in eval mode
    (``encode`` for ``what`` encoder, the logits for classifier)."""

    def __init__(self, model: nn.Module, what: str, scale_hw, crop_hw, mean, std):
        super().__init__()
        self.model = model.eval()
        self.what = what
        self.scale_hw, self.crop_hw = tuple(scale_hw), tuple(crop_hw)
        self.mean, self.std = tuple(mean), tuple(std)

    def forward(self, raw: torch.Tensor) -> torch.Tensor:
        x = multi_crop_eval(raw, self.scale_hw, self.crop_hw, 1, self.mean, self.std)[:, 0]
        out = self.model.encode(x) if self.what == "encoder" else self.model(x)
        return out.float()


def build_infer_fn(config, what: str, checkpoint: str, device) -> Tuple[InferFn, int, str]:
    """(fn, output dim, output name): the inference module on ``device``
    with the checkpoint's weights (JAX ``build_infer_fn``)."""
    inp = config.INPUT
    crop_hw = (int(inp.BASE_SIZE[0]), int(inp.BASE_SIZE[1]))
    scale_hw = (int(inp.SCALE_SIZE[0]), int(inp.SCALE_SIZE[1]))
    if what == "encoder":
        model, out_dim = create_visual_model(config)
        out_name = "features"
    else:
        model, _ = create_video_model(config)
        out_dim, out_name = int(config.DATASET.NUM_CLASS), "logits"
    sd, meta = load_params_only(checkpoint)
    model.load_state_dict(sd, strict=True)
    print(f"=> loaded '{checkpoint}' (epoch {meta.get('epoch')})")
    fn = InferFn(place(model, device), what, scale_hw, crop_hw, inp.MEAN, inp.STD)
    return fn, out_dim, out_name


def export(config, args) -> dict:
    """Export, write the artifact and manifest, validate; returns the
    manifest with ``validate_err`` (None under ``--skip_validate``)."""
    device = resolve_device(args.device)
    fn, out_dim, out_name = build_infer_fn(config, args.what, args.checkpoint, device)
    t = int(config.INPUT.VIDEO_LENGTH)
    scale_hw = (int(config.INPUT.SCALE_SIZE[0]), int(config.INPUT.SCALE_SIZE[1]))
    b = 2 if args.poly else int(args.batch)
    example = torch.zeros((b, t, *scale_hw, 3), dtype=torch.uint8, device=device)
    dynamic = ({0: torch.export.Dim("b", max=BATCH_MAX)},) if args.poly else None
    with torch.no_grad():
        program = torch.export.export(fn, (example,), dynamic_shapes=dynamic)

    os.makedirs(args.output, exist_ok=True)
    path = os.path.join(args.output, f"{args.what}.pt2")
    torch.export.save(program, path)
    manifest = {
        "what": args.what,
        "input": {"shape": ["b" if args.poly else int(args.batch), t, *scale_hw, 3],
                  "dtype": "uint8",
                  "layout": "(B, T, H, W, RGB) raw frames at SCALE_SIZE; "
                            "center crop + normalize run inside"},
        "output": {"name": out_name, "dim": int(out_dim), "dtype": "float32"},
        "device": str(device),
        "backbone": config.MODEL.BACKBONE,
        "checkpoint": os.path.abspath(args.checkpoint),
        "torch_version": torch.__version__,
        "bytes": os.path.getsize(path),
    }
    with open(os.path.join(args.output, f"{args.what}.manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)

    err = None
    if not args.skip_validate:
        rng = np.random.default_rng(0)
        raw = torch.from_numpy(rng.integers(0, 256, (b, t, *scale_hw, 3), dtype=np.uint8))
        raw = raw.to(device)
        with torch.no_grad():
            want = fn(raw)
            got = torch.export.load(path).module()(raw)
        err = float((want - got).abs().max())
        print(f"validate: max|live - artifact| = {err:.3e}")
        if not err < TOL_VALIDATE:
            raise RuntimeError(f"the artifact differs from the live model by {err:.3e}")
    print(f"exported {args.what} -> {path} ({manifest['bytes'] / 1e6:.2f} MB), "
          f"device={device}")
    return {**manifest, "validate_err": err}


def main(argv: Optional[list] = None) -> dict:
    args = get_parser().parse_intermixed_args(argv)
    return export(load_config(args.config_file, args.opts), args)


if __name__ == "__main__":
    main()
