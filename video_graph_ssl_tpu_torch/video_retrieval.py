"""Video retrieval on a GPU: feature extraction and nearest-neighbour R@k --
the port's counterpart of ``tools/video_retrieval.py``::

    python -m video_graph_ssl_tpu_torch.video_retrieval \\
        --config_file configs/visual_moco.yaml DATASET.SOURCE synthetic \\
        --checkpoint run/.../checkpoint_N.pth.tar --extract_feature \\
        --feature_dir feats/ [--test_clips 10] [--test_crops 1] [--max_videos N]
    python -m video_graph_ssl_tpu_torch.video_retrieval --feature_dir feats/ \\
        [--dist_metric euclidean]

With ``--extract_feature`` the pretrain model (``create_visual_model``,
loaded strictly from a checkpoint of the port's pretrain trainer) encodes
the train and val splits: each clip resized to ``INPUT.SCALE_SIZE`` and
cropped to ``INPUT.BASE_SIZE`` (``--test_crops`` crops), the encoder's
features (projection head dropped) averaged over clips x crops, pickled
as ``<split>_features.pkl``.  Then val -> train nearest-neighbour retrieval
by cosine or euclidean distance over L2-normalised features reports
R@{1,5,10,20,50} (k up to the train count) and writes
``topk_correct.json``.  ``--save_vis N`` draws the first N queries with
their top-5 neighbours (needs cv2).  ``--device`` defaults to ``cuda`` and
raises when no GPU is present.

Across ranks (``train_ds``'s launchers: torchrun, ``--world_size N --rank R
--dist-url URL``, ``--multiprocessing-distributed``) each batch is padded to
a multiple of the world size, each rank encodes its share of it and the
features are gathered in rank order (``parallel.dist.eval_over_ranks``);
rank 0 alone writes the feature pickles, ``topk_correct.json`` and the
figures, and prints R@k.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from typing import Callable, Optional

import numpy as np
import torch

from .data.build import make_test_loader
from .data.pipeline import to_device
from .data.transforms_device import N_CROPS
from .engine.downstream import make_feature_step
from .models.build import create_visual_model
from .models.layers import place
from .parallel import dist
from .test_ds import crops_of
from .train_video_contrast_dis import add_dist_args, launch, resolve_device
from .utils.checkpoint import load_params_only

TOPK = (1, 5, 10, 20, 50)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Video retrieval R@k (PyTorch port)")
    parser.add_argument("--config_file", default="", type=str)
    add_dist_args(parser)
    parser.add_argument("--checkpoint", default="", type=str)
    parser.add_argument("--extract_feature", action="store_true")
    parser.add_argument("--feature_dir", default="features", type=str)
    parser.add_argument("--dist_metric", default="cosine", choices=["cosine", "euclidean"])
    parser.add_argument("--l2_norm", action="store_true", default=True)
    parser.add_argument("--test_clips", default=10, type=int)
    parser.add_argument("--test_crops", default=1, type=int, choices=list(N_CROPS),
                        help="spatial crops averaged per clip")
    parser.add_argument("--max_videos", default=0, type=int)
    parser.add_argument("--save_vis", default=0, type=int,
                        help="write retrieval strips (query + top-5 neighbours) for "
                             "the first N val videos")
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("opts", nargs="*", help="config overrides: KEY VALUE ...")
    return parser


def build_feature_fn(config, n_crops: int = 1) -> Callable:
    """fn(model, raw (B, n_clips, T, H, W, C) uint8) -> (B, D) encoder
    features averaged over clips x crops (reference: extract_feature,
    video_retrieval.py:101-152)."""
    step = make_feature_step()

    def feat_fn(model: torch.nn.Module, raw: torch.Tensor) -> torch.Tensor:
        feats = step(model, crops_of(raw, config, n_crops, "BASE_SIZE"))
        return feats.reshape(raw.shape[0], -1, feats.shape[-1]).mean(dim=1)

    return feat_fn


def _split_cfg(config, split: str):
    c = config.clone()
    c.defrost()
    if split == "train":
        c.DATASET.VALIDATION_SPLIT = config.DATASET.TRAIN_SPLIT
    return c


def extract_split(config, args, model, split: str, device) -> np.ndarray:
    """Encode ``split``'s videos (each batch shared out over the ranks) and
    pickle {features, classes} under ``--feature_dir`` (rank 0); returns
    the features, on every rank."""
    loader = make_test_loader(_split_cfg(config, split), num_clips=args.test_clips)
    feat_fn = build_feature_fn(config, n_crops=args.test_crops)

    def feats_of(rows: np.ndarray) -> torch.Tensor:
        return feat_fn(model, to_device(rows, device))

    feats, classes, seen = [], [], 0
    t0 = time.perf_counter()
    batches = loader.epoch(0)
    try:
        for batch in batches:
            feats.append(dist.eval_over_ranks(feats_of, batch["clips"]).float().cpu().numpy())
            classes.append(batch["label"])
            seen += len(batch["label"])
            if dist.is_main():
                print(f"[{split}] extracted {seen} videos", flush=True)
            if args.max_videos and seen >= args.max_videos:
                break
    finally:
        batches.close()
    feats, classes = np.concatenate(feats), np.concatenate(classes)
    if not dist.is_main():
        return feats
    os.makedirs(args.feature_dir, exist_ok=True)
    out = os.path.join(args.feature_dir, f"{split}_features.pkl")
    with open(out, "wb") as f:
        pickle.dump({"features": feats, "classes": classes}, f)
    print(f"saved {out}: {feats.shape} in {time.perf_counter() - t0:.1f} s")
    return feats


def topk_retrieval(args, config=None) -> dict:
    """val -> train R@k over the pickled features (reference: topk_retrieval,
    video_retrieval.py:156-209); writes ``topk_correct.json``."""
    with open(os.path.join(args.feature_dir, "train_features.pkl"), "rb") as f:
        train = pickle.load(f)
    with open(os.path.join(args.feature_dir, "val_features.pkl"), "rb") as f:
        val = pickle.load(f)
    x_train, y_train = train["features"], train["classes"]
    x_val, y_val = val["features"], val["classes"]
    if args.l2_norm:
        x_train = x_train / np.maximum(np.linalg.norm(x_train, axis=1, keepdims=True), 1e-12)
        x_val = x_val / np.maximum(np.linalg.norm(x_val, axis=1, keepdims=True), 1e-12)
    if args.dist_metric == "cosine":
        dist = 1.0 - x_val @ x_train.T
    else:
        dist = ((x_val[:, None, :] - x_train[None, :, :]) ** 2).sum(-1)
    order = np.argsort(dist, axis=1)
    ks = [k for k in TOPK if k <= x_train.shape[0]]
    hits = y_train[order] == y_val[:, None]
    recalls = {k: 100.0 * int(hits[:, :k].any(axis=1).sum()) / len(x_val) for k in ks}
    for k in ks:
        print(f"R@{k}: {recalls[k]:.2f}%")
    with open(os.path.join(args.feature_dir, "topk_correct.json"), "w") as f:
        json.dump(recalls, f)
    if args.save_vis:
        save_retrieval_vis(args, config, order, y_train, y_val)
    return recalls


def _middle_frames(config, args, split: str, wanted: set) -> dict:
    """{video index: its first clip's middle frame (H, W, 3) uint8} for the
    ``wanted`` videos of the deterministic test loader."""
    loader = make_test_loader(_split_cfg(config, split), num_clips=1)
    frames, seen = {}, 0
    batches = loader.epoch(0)
    try:
        for batch in batches:
            clips = batch["clips"]                      # (B, 1, T, H, W, C)
            for b in range(clips.shape[0]):
                if seen + b in wanted:
                    frames[seen + b] = np.asarray(clips[b, 0, clips.shape[2] // 2])
            seen += clips.shape[0]
            if (args.max_videos and seen >= args.max_videos) or len(frames) == len(wanted):
                break
    finally:
        batches.close()
    return frames


def save_retrieval_vis(args, config, order, y_train, y_val, n_neighbors: int = 5) -> None:
    """Strips of [query | top-k neighbours], green border where the class
    matches, red where it does not (``retrieval_vis.png``)."""
    try:
        import cv2
    except Exception:
        print("save_vis: cv2 unavailable, skipping")
        return
    n = min(int(args.save_vis), len(y_val))
    qf = _middle_frames(config, args, "val", set(range(n)))
    tf = _middle_frames(config, args, "train",
                        {int(j) for i in range(n) for j in order[i, :n_neighbors]})

    def bordered(img, good):
        color = (40, 200, 60) if good else (220, 50, 50)
        return cv2.copyMakeBorder(img, 4, 4, 4, 4, cv2.BORDER_CONSTANT, value=color)

    rows = []
    for i in range(n):
        if i not in qf:
            continue
        tiles = [bordered(qf[i], True)] + [
            bordered(tf[int(j)], y_train[int(j)] == y_val[i])
            for j in order[i, :n_neighbors] if int(j) in tf]
        rows.append(np.concatenate(tiles, axis=1))
    if not rows:
        print("save_vis: no frames collected, skipping")
        return
    w = max(r.shape[1] for r in rows)
    grid = np.concatenate([np.pad(r, ((0, 0), (0, w - r.shape[1]), (0, 0))) for r in rows])
    out = os.path.join(args.feature_dir, "retrieval_vis.png")
    cv2.imwrite(out, grid[..., ::-1])
    print(f"saved {out}: {len(rows)} query rows x top-{n_neighbors}")


def load_encoder(config, checkpoint: str, device) -> torch.nn.Module:
    """The pretrain model on ``device``, loaded strictly from a checkpoint of
    the port's pretrain trainer when one is given."""
    model, _ = create_visual_model(config)
    model = place(model, device)
    if checkpoint:
        sd, meta = load_params_only(checkpoint)
        model.load_state_dict(sd, strict=True)
        if dist.is_main():
            print(f"=> loaded '{checkpoint}' (epoch {meta.get('epoch')})")
    return model


def retrieve(config, args, device: str) -> Optional[dict]:
    """The body of :func:`launch`: extract the features where asked, then
    R@k on rank 0 (None on the other ranks)."""
    if args.extract_feature:
        device = resolve_device(device)
        model = load_encoder(config, args.checkpoint, device)
        for split in ("train", "val"):
            extract_split(config, args, model, split, device)
    return topk_retrieval(args, config) if dist.is_main() else None


def main(argv: Optional[list] = None) -> Optional[dict]:
    return launch(get_parser().parse_intermixed_args(argv), retrieve)


if __name__ == "__main__":
    main()
