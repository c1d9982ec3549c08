"""Does the GCA graph module help, on the port?  The counterpart of the JAX
package's ``perf/graph_benefit_lab.py``, with the same names, CLI and
record schema.

A/B: pretrain tiny3d with ``MODEL.AUG_FLAG`` True (the graph block at aug
point 1) and False on a synthetic probe set, then compare nearest-neighbour
retrieval top-1 over the encoder's features (eval mode), before and after.
On ``temporal_shortcut_clips`` frame order is an instance shortcut and
content the class signal, so the graph arm should win; on
``temporal_motion_clips`` the class signal is the frame order, so it
should lose (the negative control).

    python -m video_graph_ssl_tpu_torch.graph_benefit --regimes moco bank simsiam \\
        --seeds 0 1 2 --epochs 150 --jsonl out.jsonl [--dataset motion] [--device cpu]

Each run goes through the port's own entry points
(``models.create_visual_model``, ``engine.build.create_pretrain_state``,
``engine.pretrain.make_pretrain_step`` on the float clips, the encoder in
``eval()``) and keeps the lab's conventions: the batch order is
``np.random.default_rng(seed + 1).permutation`` per epoch, the last partial
batch dropped; ``index`` is the batch's dataset rows; ``loss_first`` and
``loss_last`` are the last step's loss of the first and of the last epoch.
The step runs in full fp32 (``TPU.COMPUTE_DTYPE float32``; TF32 off for the
run) on cuDNN's deterministic algorithms, so a seed repeats bit for bit on
one card and software stack (K1 draws its noise from the step's seed).
``--device cuda`` (the default) raises without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Callable, Optional

import numpy as np
import torch


def make_cfg(regime: str, aug: bool, t: int, hw: int, feat_dim: int = 32,
             graph_overrides=()):
    from .config import cfg as CFG

    c = CFG.clone()
    c.MODEL.BACKBONE = "tiny3d"
    c.MODEL.BACKBONE_TYPE = "3D"
    c.MODEL.AUG_FLAG = bool(aug)
    c.MODEL.DROPOUT = 0.0
    c.INPUT.BASE_SIZE = [hw, hw]
    c.INPUT.CROP_SIZE = [hw, hw]
    c.INPUT.SCALE_SIZE = [hw + 4, hw + 4]
    c.INPUT.VIDEO_LENGTH = t
    c.DATASET.NUM_CLASS = 4
    c.DATASET.SOURCE = "synthetic"
    c.CONTRAST.MEM_TYPE = regime
    c.CONTRAST.NCE_K = 16
    c.CROSS.FEAT_DIM = feat_dim
    c.TPU.COMPUTE_DTYPE = "float32"
    if graph_overrides:
        c.merge_from_list(list(graph_overrides))
    return c


def retrieval_top1(feats: np.ndarray, labels: np.ndarray) -> float:
    f = feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-9)
    sim = f @ f.T
    np.fill_diagonal(sim, -np.inf)
    return float((labels[sim.argmax(axis=1)] == labels).mean())


@contextlib.contextmanager
def reproducible_fp32():
    """While the block runs: TF32 off for cuBLAS and cuDNN, and cuDNN's
    deterministic algorithms (its default fp32 weight-gradient algorithms
    sum with atomics, so a seed did not repeat on the card)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    matmul.allow_tf32 = cudnn.allow_tf32 = cudnn.benchmark = False
    cudnn.deterministic = True
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = flags


def run_one(regime: str, aug: bool, seed: int, epochs: int, t: int, hw: int,
            per_class: int, lr: float, batch_size: int = 16,
            graph_overrides=(), noise: float = 0.5, dataset: str = "shortcut",
            device: str = "cuda", init: Optional[Callable] = None) -> dict:
    """One arm: ``epochs`` of ``regime`` pretraining on the probe set of
    ``seed`` -> {before, after, loss_first, loss_last}.  ``init(state)``,
    when given, loads a state (say, the JAX package's initial one) into the
    fresh ``PretrainState`` before training."""
    from .data.synthetic import temporal_motion_clips, temporal_shortcut_clips
    from .engine.build import create_pretrain_state
    from .engine.pretrain import make_pretrain_step
    from .models.build import create_visual_model
    from .train_video_contrast_dis import resolve_device

    dev = resolve_device(device)
    cfg = make_cfg(regime, aug, t, hw, graph_overrides=graph_overrides)
    cfg.MODEL.SEED = seed
    make_clips = {"motion": temporal_motion_clips,
                  "shortcut": temporal_shortcut_clips}[dataset]
    clips, labels = make_clips(per_class=per_class, t=t, hw=(hw, hw), seed=seed,
                               noise=noise)
    x = torch.from_numpy(clips).to(dev)
    n = len(labels)

    model, _ = create_visual_model(cfg)
    state = create_pretrain_state(cfg, model, dev, n_data=n)
    if init is not None:
        init(state)

    def top1() -> float:
        state.model.eval()
        with torch.no_grad():
            feats = state.model.encode(x[:, 0]).float().cpu().numpy()
        return retrieval_top1(feats, labels)

    with reproducible_fp32():
        before = top1()
        step = make_pretrain_step(cfg)
        order_rng = np.random.default_rng(seed + 1)
        first = last = None
        for _epoch in range(epochs):
            order = order_rng.permutation(n)
            for s in range(0, n - batch_size + 1, batch_size):
                idx = torch.from_numpy(order[s:s + batch_size]).to(dev)
                metrics = step(state, x[idx], lr, idx)
            last = float(metrics["loss"])
            if first is None:
                first = last
        after = top1()
    return dict(before=before, after=after, loss_first=first, loss_last=last)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--regimes", nargs="*", default=["moco", "simsiam"])
    ap.add_argument("--seeds", nargs="*", type=int, default=[0, 1, 2])
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--t", type=int, default=8)
    ap.add_argument("--hw", type=int, default=16)
    ap.add_argument("--per_class", type=int, default=12)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--noise", type=float, default=0.5)
    ap.add_argument("--dataset", choices=["shortcut", "motion"], default="shortcut",
                    help="shortcut: order is an instance shortcut, content the class "
                         "signal (the graph arm should win); motion: the class signal "
                         "is the frame order (the negative control: it should lose)")
    ap.add_argument("--graph_opts", nargs="*", default=[],
                    help="config overrides for the AUG_FLAG=True arm only, "
                         "e.g. --graph_opts GRAPH.SAMPLER gaussian")
    ap.add_argument("--jsonl", default="",
                    help="append one JSON record per regime/seed pair to this path")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)
    from .kernel_times import gpu_line

    on_card = torch.device(args.device).type == "cuda"
    records = []
    for regime in args.regimes:
        margins = []
        for seed in args.seeds:
            row = {}
            for aug in (True, False):
                t0 = time.perf_counter()
                r = run_one(regime, aug, seed, args.epochs, args.t, args.hw,
                            args.per_class, args.lr,
                            graph_overrides=args.graph_opts if aug else (),
                            noise=args.noise, dataset=args.dataset, device=args.device)
                r["sec"] = round(time.perf_counter() - t0, 3)
                row[aug] = r
            margin = row[True]["after"] - row[False]["after"]
            margins.append(margin)
            records.append({
                "regime": regime, "seed": seed, "dataset": args.dataset,
                "epochs": args.epochs, "backend": "cuda" if on_card else "cpu",
                "device": gpu_line() if on_card else "cpu",
                "graph": row[True], "nograph": row[False],
                "margin": round(margin, 4),
            })
            g, p = row[True], row[False]
            print(f"{regime:8s} seed{seed} graph {g['after']:.3f} (before {g['before']:.3f}, "
                  f"loss {g['loss_first']:.3f}->{g['loss_last']:.3f}) | nograph "
                  f"{p['after']:.3f} (before {p['before']:.3f}, loss "
                  f"{p['loss_first']:.3f}->{p['loss_last']:.3f}) | margin {margin:+.3f} "
                  f"[{g['sec']:.1f}s/{p['sec']:.1f}s]", flush=True)
        print(f"{regime:8s} mean margin {np.mean(margins):+.3f} "
              f"min {np.min(margins):+.3f}", flush=True)
    if args.jsonl:
        with open(args.jsonl, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        print(f"appended {len(records)} records to {args.jsonl}", flush=True)
    return records


if __name__ == "__main__":
    main()
