"""Downstream action recognition on a GPU: fine-tune or linear probe -- the
port's counterpart of ``tools/train_ds.py``, same CLI and YAML::

    python -m video_graph_ssl_tpu_torch.train_ds \\
        --config_file configs/action_fine_tune.yaml DATASET.SOURCE synthetic \\
        [--ssl_checkpoint run/.../checkpoint_N.pth.tar] --max_steps 5

The encoder starts from a pretrain checkpoint of the port's trainer
(``--ssl_checkpoint`` or ``MODEL.PRETRAIN_PATH``; MoCo, SimSiam or bank) by
checkpoint surgery, with a fresh ``new_fc``; ``/`` or ``none`` means a
random encoder.  ``MODEL.PRETRAIN_PATH`` may also name a bare backbone
state_dict, the reference's names included (S3DG, I3D, the ResNets,
BN-Inception, Inception-v3; ``utils/torch_names.py``): it loads strictly
into the backbone.  ``MODEL.LINEAR_PROBE True`` trains ``new_fc`` alone;
``MODEL.PROBE_BN`` then chooses the encoder's BN: ``eval`` (the whole model
in eval mode) or ``reference`` (the reference's partial-BN train mode:
``stem_0``'s BNs live, the rest on running statistics).  Fine-tuning runs
partial BN unless ``MODEL.NO_PARTIALBN``.

Each epoch trains, then validates every ``CHECKPOINT.EVAL_INTERVAL``
epochs (top-1/top-5 of the concatenated logits, ``model_best_state.pth.tar``
when top-1 improves), with ``checkpoint_<epoch>.pth.tar`` every
``CHECKPOINT.CHECKPOINT_INTERVAL``.  SIGTERM finishes the step, writes
``checkpoint_preempt.pth.tar`` and exits 0.  ``--max_steps`` caps the steps
of an epoch and the batches of a validation, and stops after the first
epoch.  Runs live under ``run/<dataset>/<checkname>/experiment_NN``.

``--device`` defaults to ``cuda`` and raises when no GPU is present.

Several GPUs, as the JAX tool runs on a mesh: one process per rank under
``torch.distributed``, with the pretrain trainer's launchers (torchrun's
environment, or ``--world_size N --rank R --dist-url URL``, or
``--multiprocessing-distributed``; ``--dist-backend`` nccl or gloo)::

    torchrun --nproc_per_node 4 -m video_graph_ssl_tpu_torch.train_ds \
        --config_file configs/action_fine_tune.yaml ...

``DATALOADER.BATCH_SIZE`` is global: each rank trains on its rows of every
global batch (``DistributedDataParallel`` over the trainable parameters,
the live BNs over the global batch, the draws as the global batch's rows),
and each validation batch is shared out over the ranks and its logits
gathered (``parallel.dist.eval_over_ranks``), so every rank holds the same
top-1 and ``best_pred``.  Only rank 0 prints and writes; SIGTERM on any
rank stops every rank after the same step.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from .data.build import make_data_loader
from .data.pipeline import to_device
from .engine.build import create_downstream_state
from .engine.downstream import make_fused_downstream_step, make_fused_eval_step
from .models.build import create_video_model
from .parallel import dist
from .solver.build import make_lr_scheduler
from .train_video_contrast_dis import (add_dist_args, launch, load_backbone_state_dict,
                                       resolve_device)
from .utils.checkpoint import (SSL_ENCODER, read_payload, transfer_encoder_params,
                               wait_for_async_checkpoints)
from .utils.meters import AverageMeter, accuracy
from .utils.summary import creat_saver

PROBE_BN_MODES = ("eval", "reference")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Downstream action training on a GPU (PyTorch port)")
    parser.add_argument("--config_file", default="", type=str)
    add_dist_args(parser)
    parser.add_argument("--ssl_checkpoint", default="", type=str,
                        help="pretrain checkpoint to initialise the encoder from "
                             "(MODEL.PRETRAIN_PATH also works)")
    parser.add_argument("--max_steps", default=0, type=int,
                        help="cap the steps of an epoch and the batches of a "
                             "validation, and stop after one epoch (0 = unlimited)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to train on (default: cuda)")
    parser.add_argument("opts", nargs="*", help="config overrides: KEY VALUE ...")
    return parser


def bn_train_of(config) -> bool:
    """Whether the train step runs the model in train mode: always when
    fine-tuning, under ``PROBE_BN reference`` when probing."""
    probe_bn = str(config.MODEL.PROBE_BN)
    if probe_bn not in PROBE_BN_MODES:
        raise ValueError(f"MODEL.PROBE_BN must be one of {PROBE_BN_MODES}, got {probe_bn}")
    return not bool(config.MODEL.LINEAR_PROBE) or probe_bn == "reference"


class Trainer:
    """Counterpart of the JAX tool's Trainer: the model, the surgery, the
    downstream state, the fused train and eval steps, the loaders, the LR
    schedule, the saver and the meters.  Under a process group (initialised
    by the caller) it is one rank: it trains on its rows of each global
    batch, and only rank 0 writes and prints."""

    def __init__(self, config, ssl_checkpoint: str = "", max_steps: int = 0,
                 device: str = "cuda", run_dir: str = "run"):
        self.cfg = config
        self.max_steps = int(max_steps)
        self.bn_train = bn_train_of(config)
        self.device = resolve_device(device)
        # first: it refuses what is not ported before anything is built
        self.step_fn = make_fused_downstream_step(config, self.bn_train)
        self.is_main = dist.is_main()
        self.batch_slice = (dist.process_batch_slice(int(config.DATALOADER.BATCH_SIZE))
                            if dist.is_distributed() else None)
        # SIGTERM reaches each rank on its own: the ranks vote after every step
        self.vote_group = dist.host_group()
        model, _ = create_video_model(config)
        # the surgery comes before the state, which checks under a group
        # that every rank holds the same model
        self._load_ssl_checkpoint(model, ssl_checkpoint or config.MODEL.PRETRAIN_PATH)
        self.state = create_downstream_state(config, model, self.device)
        self.eval_fn = make_fused_eval_step(config)
        self.train_loader = make_data_loader(config, is_train=True,
                                             batch_slice=self.batch_slice)
        self.val_loader = make_data_loader(config, is_train=False)
        self.lr_fn = make_lr_scheduler(config)
        self.saver, self.writer = creat_saver(config, base_dir=run_dir)
        self.batch_size = int(config.DATALOADER.BATCH_SIZE)
        self.best_pred = 0.0
        self.meters = {k: AverageMeter() for k in ("batch_time", "data_time", "loss",
                                                   "top1", "top5")}
        self._preempted = False

    def _on_sigterm(self, signum, frame):
        print("=> SIGTERM: checkpointing after the current step...", flush=True)
        self._preempted = True

    def _load_ssl_checkpoint(self, model, path) -> None:
        """Checkpoint surgery into ``model`` (reference: train_ds.py:65-84).
        A file that is not a pretrain checkpoint (through
        ``MODEL.PRETRAIN_PATH``: a bare backbone state_dict, the reference's
        names included) loads strictly into the backbone."""
        if not path or str(path) in ("none", "/"):
            return
        if not os.path.exists(path):
            raise RuntimeError(f"=> no SSL checkpoint found at '{path}'")
        payload = read_payload(path)
        sd = payload.get("state_dict") if isinstance(payload, dict) else None
        if not (isinstance(sd, dict)
                and any(k.startswith((SSL_ENCODER, "model_1.")) for k in sd)):
            model.base_model.load_state_dict(load_backbone_state_dict(path), strict=True)
            self._log(f"=> initialized backbone from '{path}', new_fc randomly initialized")
            return
        transfer_encoder_params(sd, model)
        meta = payload.get("meta", {})
        self._log(f"=> initialized encoder from '{path}' (epoch {meta.get('epoch')}), "
                  "new_fc randomly initialized")

    def _log(self, line: str) -> None:
        if self.is_main:
            print(line, flush=True)

    def batch_to_device(self, batch: dict):
        """(raw uint8 clips, int64 labels) of a host batch on the device."""
        return (to_device(batch["clips"], self.device),
                to_device(batch["label"].astype(np.int64), self.device))

    def train_step(self, clips: torch.Tensor, labels: torch.Tensor,
                   lr: float) -> Dict[str, torch.Tensor]:
        return self.step_fn(self.state, clips, labels, lr)

    def _capped(self, i: int) -> bool:
        return bool(self.max_steps) and i + 1 >= self.max_steps

    def training(self, epoch: int) -> None:
        for m in self.meters.values():
            m.reset()
        lr = self.lr_fn(epoch)
        n_iter = len(self.train_loader)
        print_freq = int(self.cfg.CHECKPOINT.PRINT_FREQ)
        bsz = self.batch_size
        batches = self.train_loader.epoch(epoch)
        end = time.time()
        try:
            for i, batch in enumerate(batches):
                self.meters["data_time"].update(time.time() - end)
                metrics = self.train_step(*self.batch_to_device(batch), lr)
                if i % print_freq == 0 or i == n_iter - 1:
                    m = {k: float(v) for k, v in metrics.items()}   # device sync
                    for k in ("loss", "top1", "top5"):
                        self.meters[k].update(m[k], bsz)
                    self.meters["batch_time"].update(time.time() - end)
                    self.writer.add_scalar("train/total_loss_iter", m["loss"],
                                           i + n_iter * epoch)
                    mt = self.meters
                    self._log(f"Epoch: [{epoch}][{i}/{n_iter}], lr: {lr:.5f}\t"
                              f"Time {mt['batch_time'].val:.3f} ({mt['batch_time'].avg:.3f})\t"
                              f"Loss {mt['loss'].val:.4f} ({mt['loss'].avg:.4f})\t"
                              f"Prec@1 {mt['top1'].val:.3f} ({mt['top1'].avg:.3f})\t"
                              f"Prec@5 {mt['top5'].val:.3f} ({mt['top5'].avg:.3f})")
                end = time.time()
                if dist.any_rank(self._preempted, self.vote_group):
                    self._preempted = True
                    self._log("======>Preemption Checkpoint...")
                    self.saver.save_checkpoint(self.state, epoch, self.best_pred,
                                               filename="checkpoint_preempt.pth.tar")
                    return
                if self._capped(i):
                    break
        finally:
            batches.close()
        self.writer.add_scalar("train/loss", self.meters["loss"].avg, epoch)
        self.writer.add_scalar("train/top1_acc", self.meters["top1"].avg, epoch)
        self.writer.add_scalar("lr", lr, epoch)

    def val_logits(self, epoch: int):
        """(logits, labels) of the validation set as numpy arrays.  Each
        batch's rows are shared out over the ranks and the logits gathered,
        so every rank scores the whole set."""
        all_logits, all_labels = [], []

        def logits_of(rows: np.ndarray) -> torch.Tensor:
            return self.eval_fn(self.state.model, to_device(rows, self.device))

        batches = self.val_loader.epoch(epoch)
        try:
            for i, batch in enumerate(batches):
                logits = dist.eval_over_ranks(logits_of, batch["clips"])
                all_logits.append(logits.float().cpu().numpy())
                all_labels.append(batch["label"])
                if self._capped(i):
                    break
        finally:
            batches.close()
        return np.concatenate(all_logits), np.concatenate(all_labels)

    def validation(self, epoch: int) -> float:
        """Top-1/top-5 of the concatenated logits; ``model_best_state``
        when top-1 improves (reference: train_ds.py:164-221)."""
        logits, labels = self.val_logits(epoch)
        top1, top5 = accuracy(logits, labels, topk=(1, 5))
        self._log(f"Validation: [Epoch: {epoch}] Prec@1 {top1:.3f} Prec@5 {top5:.3f}")
        self.writer.add_scalar("val/top1_acc", top1, epoch)
        self.writer.add_scalar("val/top5_acc", top5, epoch)
        if top1 > self.best_pred:
            self.best_pred = top1
            self.saver.save_checkpoint(self.state, epoch + 1, self.best_pred, is_best=True,
                                       filename="model_best_state.pth.tar")
        return top1

    def run(self) -> None:
        main = threading.current_thread() is threading.main_thread()
        previous = signal.signal(signal.SIGTERM, self._on_sigterm) if main else None
        try:
            for epoch in range(int(self.cfg.SOLVER.START_EPOCH),
                               int(self.cfg.SOLVER.MAX_EPOCHS)):
                self.training(epoch)
                if self._preempted:
                    break
                if (not bool(self.cfg.CHECKPOINT.NO_VAL)
                        and (epoch + 1) % int(self.cfg.CHECKPOINT.EVAL_INTERVAL) == 0):
                    self.validation(epoch)
                if (epoch + 1) % int(self.cfg.CHECKPOINT.CHECKPOINT_INTERVAL) == 0:
                    self._log("======>Saving Checkpoint...")
                    self.saver.save_checkpoint(self.state, epoch + 1, self.best_pred,
                                               filename=f"checkpoint_{epoch + 1}.pth.tar")
                if self.max_steps:
                    break
        finally:
            if main:
                signal.signal(signal.SIGTERM, previous)
            # a save in flight commits while the process group still exists
            wait_for_async_checkpoints()
            self.writer.close()


def run_trainer(config, args, device: str) -> None:
    """The body of :func:`launch`: one rank's Trainer run."""
    if dist.is_main():
        print(f"Running with config:\n{config}")
    Trainer(config, ssl_checkpoint=args.ssl_checkpoint, max_steps=args.max_steps,
            device=device).run()


def main(argv: Optional[list] = None) -> None:
    launch(get_parser().parse_intermixed_args(argv), run_trainer)


if __name__ == "__main__":
    main()
