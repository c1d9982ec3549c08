"""Video-level evaluation with multi-clip multi-crop averaging on a GPU -- the
port's counterpart of ``tools/test_ds.py``::

    python -m video_graph_ssl_tpu_torch.test_ds \\
        --config_file configs/action_fine_tune.yaml DATASET.SOURCE synthetic \\
        --checkpoint run/.../model_best_state.pth.tar \\
        --test_crops 3 --test_clips 10 [--save_scores scores.npz] [--max_videos N]

N temporally spread clips x {1, 3, 5, 6, 10} spatial crops per video
(``data/transforms_device.py:multi_crop_eval``), one forward over all of a
batch's crops, the logits averaged into one video score; top-1/top-5, the
confusion matrix, the mean per-class accuracy over non-empty classes, and
the scores as an ``.npz``.  ``TEST.BATCH_SIZE`` videos go through one
forward.  The checkpoint (``train_ds``'s) loads strictly.  ``--device``
defaults to ``cuda`` and raises when no GPU is present.

Across ranks (``train_ds``'s launchers: torchrun, ``--world_size N --rank R
--dist-url URL``, ``--multiprocessing-distributed``) each batch is padded to
a multiple of the world size, each rank scores its share of it and the
scores are gathered in rank order (``parallel.dist.eval_over_ranks``), as
the JAX tool shards a padded batch over the mesh; rank 0 alone prints the
report and writes ``--save_scores``.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from .data.build import make_test_loader
from .data.pipeline import to_device
from .data.transforms_device import N_CROPS, multi_crop_eval
from .engine.build import create_downstream_state
from .engine.downstream import make_eval_step
from .models.build import create_video_model
from .parallel import dist
from .train_video_contrast_dis import add_dist_args, launch, resolve_device
from .utils.checkpoint import load_checkpoint_state
from .utils.meters import accuracy


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Video-level evaluation (PyTorch port)")
    parser.add_argument("--config_file", default="", type=str)
    add_dist_args(parser)
    parser.add_argument("--checkpoint", default="", type=str, required=True)
    parser.add_argument("--test_crops", default=1, type=int, choices=list(N_CROPS))
    parser.add_argument("--test_clips", default=10, type=int)
    parser.add_argument("--save_scores", default="", type=str,
                        help="optional .npz path for per-video scores")
    parser.add_argument("--max_videos", default=0, type=int,
                        help="debug: cap evaluated videos")
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("opts", nargs="*", help="config overrides: KEY VALUE ...")
    return parser


def crops_of(raw: torch.Tensor, config, n_crops: int, size_key: str = "CROP_SIZE"):
    """(B, n_clips, T, H, W, C) uint8 -> (B * n_clips * n_crops, T, h, w, C)
    float32: each clip resized to ``INPUT.SCALE_SIZE`` and cut into
    ``n_crops`` crops of ``INPUT.<size_key>``."""
    inp = config.INPUT
    size = getattr(inp, size_key)
    crop_hw = (int(size[0]), int(size[1]))
    scale_hw = (int(inp.SCALE_SIZE[0]), int(inp.SCALE_SIZE[1]))
    x = multi_crop_eval(raw.reshape((-1,) + raw.shape[2:]), scale_hw, crop_hw, n_crops,
                        tuple(inp.MEAN), tuple(inp.STD))
    return x.reshape((-1,) + x.shape[2:])


def build_eval_fn(config, n_crops: int) -> Callable:
    """fn(model, raw clips (B, n_clips, T, H, W, C) uint8) -> video scores
    (B, num_class): the logits averaged over clips x crops (reference:
    eval_video, test_ds.py:134-149)."""
    step = make_eval_step()

    def eval_fn(model: torch.nn.Module, raw: torch.Tensor) -> torch.Tensor:
        logits = step(model, crops_of(raw, config, n_crops))
        return logits.reshape(raw.shape[0], -1, logits.shape[-1]).mean(dim=1)

    return eval_fn


def scores_report(scores: np.ndarray, labels: np.ndarray) -> dict:
    """top-1/top-5, the confusion matrix and the mean per-class accuracy over
    the classes that have videos."""
    top1, top5 = accuracy(scores, labels, topk=(1, 5))
    num_class = scores.shape[1]
    conf = np.zeros((num_class, num_class), np.int64)
    np.add.at(conf, (labels, scores.argmax(axis=1)), 1)
    cnt = conf.sum(axis=1)
    cls_acc = np.where(cnt > 0, np.diag(conf) / np.maximum(cnt, 1), 0.0)
    return {"top1": top1, "top5": top5, "confusion": conf,
            "mean_class_acc": float(cls_acc[cnt > 0].mean() * 100.0)}


def evaluate(config, args, device: str) -> Optional[dict]:
    """The body of :func:`launch`: score the test set; the report on rank
    0, None on the other ranks."""
    device = resolve_device(device)
    log = print if dist.is_main() else (lambda *a, **k: None)
    model, _ = create_video_model(config)
    state = create_downstream_state(config, model, device)
    meta = load_checkpoint_state(args.checkpoint, state)
    log(f"=> loaded checkpoint '{args.checkpoint}' (epoch {meta.get('epoch')})")
    loader = make_test_loader(config, num_clips=args.test_clips)
    eval_fn = build_eval_fn(config, args.test_crops)

    def scores_of(rows: np.ndarray) -> torch.Tensor:
        return eval_fn(state.model, to_device(rows, device))

    scores, labels, seen = [], [], 0
    t0 = time.perf_counter()
    batches = loader.epoch(0)
    try:
        for batch in batches:
            scores.append(dist.eval_over_ranks(scores_of, batch["clips"]).float().cpu().numpy())
            labels.append(batch["label"].astype(np.int64))
            seen += len(batch["label"])
            log(f"video {seen} done", flush=True)
            if args.max_videos and seen >= args.max_videos:
                break
    finally:
        batches.close()
    seconds = time.perf_counter() - t0
    if not dist.is_main():
        return None
    scores, labels = np.concatenate(scores), np.concatenate(labels)
    rep = scores_report(scores, labels)
    print(f"Accuracy Prec@1 {rep['top1']:.02f}% Prec@5 {rep['top5']:.02f}%")
    print(f"Per-class accuracy (mean over non-empty): {rep['mean_class_acc']:.02f}%")
    print(f"{seen} videos x {args.test_clips} clips x {args.test_crops} crops in "
          f"{seconds:.1f} s")
    if args.save_scores:
        np.savez(args.save_scores, scores=scores, labels=labels)
        print(f"saved scores to {args.save_scores}")
    return rep


def main(argv: Optional[list] = None) -> Optional[dict]:
    return launch(get_parser().parse_intermixed_args(argv), evaluate)


if __name__ == "__main__":
    main()
