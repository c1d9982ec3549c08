"""SSL contrastive pretraining (GCA MoCo) on a GPU -- the port's entry point.

Counterpart of ``tools/train_video_contrast_dis.py``, same CLI and YAML::

    python -m video_graph_ssl_tpu_torch.train_video_contrast_dis \\
        --config_file configs/visual_moco.yaml MODEL.AUG_FLAG True \\
        DATASET.SOURCE synthetic --max_steps 5

``--device`` defaults to ``cuda``; when that is asked for and no GPU is
present the trainer raises, it never moves to the CPU by itself.  Ported so
far: the visual MoCo regime on synthetic data, one device; checkpoints,
resume, the frame-folder loader and multi-GPU come later.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from .config import cfg as default_cfg
from .data.synthetic import SyntheticContrastiveDataset, iterate_batches
from .engine.build import create_pretrain_state
from .engine.pretrain import make_fused_pretrain_step
from .models.build import create_visual_model
from .solver.build import make_lr_scheduler


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Video contrastive pretraining on a GPU (PyTorch port)")
    parser.add_argument("--config_file", default="", type=str,
                        help="path to YAML config")
    parser.add_argument("--max_steps", default=0, type=int,
                        help="cap total steps (0 = unlimited)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to train on (default: cuda)")
    parser.add_argument("opts", nargs="*",
                        help="config overrides: KEY VALUE ... (options may "
                             "come before or after them)")
    return parser


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class Trainer:
    """Builds the model, state, fused step and LR schedule, then runs
    epochs of synthetic batches."""

    def __init__(self, config, max_steps: int = 0, device: str = "cuda"):
        self.cfg = config
        self.max_steps = int(max_steps)
        self.device = resolve_device(device)
        if config.DATASET.SOURCE != "synthetic":
            raise NotImplementedError(
                "only DATASET.SOURCE synthetic is ported; the frame-folder "
                "loader comes later")
        self.model, self.feat_dim = create_visual_model(config)
        self.state = create_pretrain_state(config, self.model, self.device)
        self.step_fn = make_fused_pretrain_step(config)
        self.lr_fn = make_lr_scheduler(config)
        self.dataset = SyntheticContrastiveDataset(
            n_data=int(config.DATASET.NUM_CLASS) * 4,
            video_length=int(config.INPUT.VIDEO_LENGTH),
            canvas_hw=(int(config.INPUT.SCALE_SIZE[0]),
                       int(config.INPUT.SCALE_SIZE[1])),
            num_classes=int(config.DATASET.NUM_CLASS),
            seed=int(config.MODEL.SEED))
        self.batch_size = int(config.DATALOADER.BATCH_SIZE)
        self.start_epoch = int(config.SOLVER.START_EPOCH)
        self.meters = {k: AverageMeter() for k in
                       ("batch_time", "data_time", "loss", "top1", "top5")}

    def to_device(self, batch: dict) -> torch.Tensor:
        clips = torch.from_numpy(batch["clips"])
        if self.device.type == "cuda":
            clips = clips.pin_memory()
        return clips.to(self.device, non_blocking=True)

    def train_step(self, raw_clips: torch.Tensor, lr: float) -> Dict[str, torch.Tensor]:
        """One fused step on a raw uint8 (B, 2, T, H, W, 3) device batch."""
        return self.step_fn(self.state, raw_clips, lr)

    def steps_per_epoch(self) -> int:
        return len(self.dataset) // self.batch_size

    def train(self, epoch: int) -> None:
        for m in self.meters.values():
            m.reset()
        lr = self.lr_fn(epoch)
        n_iter = self.steps_per_epoch()
        print_freq = int(self.cfg.CHECKPOINT.PRINT_FREQ)
        bsz = self.batch_size
        mt = self.meters
        end = time.time()
        for i, batch in enumerate(iterate_batches(self.dataset, bsz, epoch,
                                                  int(self.cfg.MODEL.SEED))):
            clips = self.to_device(batch)
            mt["data_time"].update(time.time() - end)
            metrics = self.train_step(clips, lr)
            if i % print_freq == 0 or i == n_iter - 1:
                m = {k: float(v) for k, v in metrics.items()}   # device sync
                mt["loss"].update(m["loss"], bsz)
                mt["top1"].update(m["top1"], bsz)
                mt["top5"].update(m["top5"], bsz)
                mt["batch_time"].update(time.time() - end)
                print(
                    f"Epoch: [{epoch}][{i}/{n_iter}], lr: {lr:.5f}\t"
                    f"Time {mt['batch_time'].val:.3f} ({mt['batch_time'].avg:.3f})\t"
                    f"Data {mt['data_time'].val:.3f} ({mt['data_time'].avg:.3f})\t"
                    f"Loss {mt['loss'].val:.4f} ({mt['loss'].avg:.4f})\t"
                    f"Prec@1 {mt['top1'].val:.3f} ({mt['top1'].avg:.3f})\t"
                    f"Prec@5 {mt['top5'].val:.3f} ({mt['top5'].avg:.3f})",
                    flush=True)
            end = time.time()
            if self.max_steps and self.state.step >= self.max_steps:
                break

    def run(self) -> None:
        for epoch in range(self.start_epoch, int(self.cfg.SOLVER.MAX_EPOCHS)):
            self.train(epoch)
            if self.max_steps and self.state.step >= self.max_steps:
                break


def load_config(config_file: str = "", opts=()):
    """A clone of the default schema merged with a YAML file and overrides."""
    c = default_cfg.clone()
    if config_file:
        c.merge_from_file(config_file)
    c.merge_from_list(list(opts))
    c.freeze()
    return c


def main(argv: Optional[list] = None) -> None:
    args = get_parser().parse_intermixed_args(argv)
    config = load_config(args.config_file, args.opts)
    print(f"Running with config:\n{config}")
    trainer = Trainer(config, max_steps=args.max_steps, device=args.device)
    trainer.run()


if __name__ == "__main__":
    main()
