"""Grad-CAM for the downstream video classifiers -- the port's counterpart
of ``tools/cam.py``::

    python -m video_graph_ssl_tpu_torch.cam --config_file configs/action_fine_tune.yaml \\
        --checkpoint run/.../model_best_state.pth.tar --out_dir cams/ \\
        [--layer mixed_5c] [--class_id -1] [--max_videos 8] [--device cuda] [KEY VALUE ...]

Standard Grad-CAM (Selvaraju et al.) on a stage of the backbone (default:
S3D's and S3DG's last Inception block ``mixed_5c``, tiny3d's ``stage2``):

1. one eval forward of the classifier on the centre crop (``INPUT.
   SCALE_SIZE`` canvas cropped to ``INPUT.CROP_SIZE``, normalised), a
   forward hook keeping the stage's activation;
2. the backbone's head (S3D: spatial mean, adjacent-pair average, temporal
   mean; tiny3d: the global mean; then ``new_fc``) re-applied to that
   activation in fp32, so the gradient of the class score reaches it with
   no model surgery; the recomputed logits must equal the model's own
   (``head_err``), so a drifted head cannot give wrong maps;
3. alpha_c = the mean over (T', H', W') of that gradient, cam = ReLU(sum_c
   alpha_c A_c), min-max normalised per video, resized to (T, H, W) by
   ``jax.image.resize``'s linear method.

The gradient is taken through the head alone, so no kernel runs in a
backward; the forward runs the graph blocks' K1 and K2 on the card.
Per video it writes ``cam_{i:04d}.npz`` (cam (T, H, W) float32 in [0, 1],
frames (T, H, W, 3) uint8, label, pred, class_id) and, where cv2 is
installed, ``cam_{i:04d}.png``, a frame strip under a JET overlay.
``--device`` defaults to ``cuda`` and raises when no GPU is present.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .data.build import make_test_loader
from .data.transforms_device import multi_crop_eval, resize_weights
from .models.build import create_video_model
from .models.layers import place
from .models.s3d import head_pool
from .train_video_contrast_dis import load_config, resolve_device
from .utils.checkpoint import load_params_only

# S3D's stages under the JAX module names (models/s3d.py's ``base`` order)
S3D_STAGES = ("stem_0", "pool_1", "stem_2", "stem_3", "pool_4", "mixed_3b", "mixed_3c",
              "pool_7", "mixed_4b", "mixed_4c", "mixed_4d", "mixed_4e", "mixed_4f",
              "pool_13", "mixed_5b", "mixed_5c")


def _head_mean(act: torch.Tensor) -> torch.Tensor:
    """tiny3d's pooling: the global mean of an NCDHW activation."""
    return act.float().mean(dim=(2, 3, 4))


# backbone -> (pooling recompute on the NCDHW activation, default layer)
HEADS = {"S3D": (head_pool, "mixed_5c"), "S3DG": (head_pool, "mixed_5c"),
         "tiny3d": (_head_mean, "stage2")}


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Grad-CAM for video models (PyTorch port)")
    parser.add_argument("--config_file", default="", type=str)
    parser.add_argument("--checkpoint", default="", type=str, required=True)
    parser.add_argument("--out_dir", default="cam_out", type=str)
    parser.add_argument("--layer", default="", type=str,
                        help="backbone stage to hook (default: the backbone's last conv "
                             "stage)")
    parser.add_argument("--class_id", default=-1, type=int,
                        help="-1: use the predicted class per video")
    parser.add_argument("--max_videos", default=8, type=int)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("opts", nargs="*", help="config overrides: KEY VALUE ...")
    return parser


def check_backbone(backbone: str) -> None:
    if backbone not in HEADS:
        raise ValueError(f"Grad-CAM head recompute supports {sorted(HEADS)}, "
                         f"got {backbone}")


def stage_module(model: nn.Module, backbone: str, layer: str) -> nn.Module:
    """The module whose output is stage ``layer`` (JAX's module name): an
    S3D stage of ``base`` (the stage itself where a graph block wraps it),
    or a tiny3d ``stage0`` .. ``stage2``."""
    bb = model.base_model
    if backbone in ("S3D", "S3DG") and layer in S3D_STAGES:
        stage = bb.base[S3D_STAGES.index(layer)]
        return stage[1] if isinstance(stage, nn.Sequential) else stage
    if backbone == "tiny3d" and layer in ("stage0", "stage1", "stage2"):
        return getattr(bb, layer)
    raise ValueError(f"layer {layer!r} not found in the backbone")


def resize_linear(x: torch.Tensor, out_shape) -> torch.Tensor:
    """``jax.image.resize(x, out_shape, "linear")`` of a (B, T, H, W) map:
    each axis through :func:`resize_weights` (antialias on, as JAX's
    default)."""
    for axis, out in zip((1, 2, 3), out_shape[1:]):
        n = x.shape[axis]
        w = resize_weights(n, int(out), torch.zeros(1, device=x.device),
                           torch.full((1,), n, device=x.device), antialias=True)[0]
        x = torch.movedim(torch.tensordot(x, w, dims=([axis], [1])), -1, axis)
    return x


def build_cam_fn(config, model: nn.Module, backbone: str, layer: str,
                 out_thw: Tuple[int, int, int]) -> Callable:
    """fn(model, raw (B, T, H, W, C) uint8 canvas, class_id) -> (cam (B,
    *out_thw) in [0, 1], logits (B, K), head_err) (JAX ``build_cam_fn``)."""
    check_backbone(backbone)
    inp = config.INPUT
    crop_hw = (int(inp.CROP_SIZE[0]), int(inp.CROP_SIZE[1]))
    scale_hw = (int(inp.SCALE_SIZE[0]), int(inp.SCALE_SIZE[1]))
    mean, std = tuple(inp.MEAN), tuple(inp.STD)
    pool_fn = HEADS[backbone][0]
    hooked = stage_module(model, backbone, layer)

    def cam_fn(model: nn.Module, raw: torch.Tensor, class_id: int):
        x = multi_crop_eval(raw, scale_hw, crop_hw, 1, mean, std)[:, 0]
        seen = []
        handle = hooked.register_forward_hook(lambda m, a, out: seen.append(out))
        try:
            model.eval()
            with torch.no_grad():
                logits = model(x)
        finally:
            handle.remove()
        act = seen[0].detach().float().requires_grad_()       # (B, C, T', H', W')

        def head(a):
            return F.linear(pool_fn(a), model.new_fc.weight.float(), model.new_fc.bias.float())

        with torch.enable_grad():
            out = head(act)
            cls = (torch.full((out.shape[0],), class_id, device=out.device)
                   if class_id >= 0 else logits.argmax(dim=-1))
            grads, = torch.autograd.grad(out.gather(1, cls[:, None]).sum(), act)
        head_err = float((out.detach() - logits).abs().max())
        alpha = grads.mean(dim=(2, 3, 4), keepdim=True)
        cam = F.relu((alpha * act.detach()).sum(dim=1))        # (B, T', H', W')
        lo = cam.amin(dim=(1, 2, 3), keepdim=True)
        hi = cam.amax(dim=(1, 2, 3), keepdim=True)
        cam = (cam - lo) / (hi - lo).clamp_min(1e-8)
        return resize_linear(cam, (cam.shape[0], *out_thw)), logits, head_err

    return cam_fn


def save_overlay(path: str, frames: np.ndarray, cam: np.ndarray, alpha: float = 0.45) -> bool:
    """JET-colormap overlay strip (one row, every frame); needs cv2."""
    try:
        import cv2
    except ImportError:
        return False
    tiles = []
    for f, c in zip(frames, cam):
        heat = cv2.applyColorMap((c * 255).astype(np.uint8), cv2.COLORMAP_JET)[..., ::-1]
        tiles.append((1 - alpha) * f.astype(np.float32) + alpha * heat.astype(np.float32))
    strip = np.clip(np.concatenate(tiles, axis=1), 0, 255).astype(np.uint8)
    return bool(cv2.imwrite(path, strip[..., ::-1]))


def run(config, args) -> int:
    """Write the CAMs of the first ``--max_videos`` test videos; returns
    how many."""
    backbone = config.MODEL.BACKBONE
    check_backbone(backbone)
    layer = args.layer or HEADS[backbone][1]
    device = resolve_device(args.device)
    model, _ = create_video_model(config)
    sd, meta = load_params_only(args.checkpoint)
    model.load_state_dict(sd, strict=True)
    model = place(model, device)
    print(f"=> loaded checkpoint '{args.checkpoint}' (epoch {meta.get('epoch')})")

    os.makedirs(args.out_dir, exist_ok=True)
    base = tuple(int(s) for s in config.INPUT.CROP_SIZE)
    t = int(config.INPUT.VIDEO_LENGTH)
    cam_fn = build_cam_fn(config, model, backbone, layer, (t, base[0], base[1]))
    seen = 0
    batches = make_test_loader(config, num_clips=1).epoch(0)
    try:
        for batch in batches:
            raw = batch["clips"][:, 0]                        # (B, T, H, W, C)
            cam, logits, head_err = cam_fn(model, torch.from_numpy(raw).to(device),
                                           int(args.class_id))
            if head_err > 1e-2:
                raise RuntimeError(f"head recompute drifted from the model forward "
                                   f"(max|diff|={head_err:.2e}): the backbone head "
                                   f"changed; update cam.HEADS")
            cam, logits = cam.cpu().numpy(), logits.float().cpu().numpy()
            hh, ww = raw.shape[2], raw.shape[3]
            i0, j0 = (hh - base[0]) // 2, (ww - base[1]) // 2
            frames = raw[:, :, i0:i0 + base[0], j0:j0 + base[1]]
            n_keep = cam.shape[0]
            if args.max_videos:
                n_keep = min(n_keep, args.max_videos - seen)
            for b in range(n_keep):
                idx = seen + b
                pred = int(logits[b].argmax())
                used = pred if args.class_id < 0 else int(args.class_id)
                label = int(batch["label"][b])
                npz = os.path.join(args.out_dir, f"cam_{idx:04d}.npz")
                np.savez(npz, cam=cam[b].astype(np.float32), frames=frames[b], label=label,
                         pred=pred, class_id=used)
                png = os.path.join(args.out_dir, f"cam_{idx:04d}.png")
                ok = save_overlay(png, frames[b], cam[b])
                print(f"video {idx}: label={label} pred={pred} cam->{npz}"
                      + (f" overlay->{png}" if ok else ""))
            seen += n_keep
            if args.max_videos and seen >= args.max_videos:
                break
    finally:
        batches.close()
    print(f"wrote {seen} CAMs to {args.out_dir}")
    return seen


def main(argv: Optional[list] = None) -> int:
    args = get_parser().parse_intermixed_args(argv)
    return run(load_config(args.config_file, args.opts), args)


if __name__ == "__main__":
    main()
