"""SSL contrastive pretraining on a GPU -- the port's entry point.

Counterpart of ``tools/train_video_contrast_dis.py``, same CLI and YAML::

    python -m video_graph_ssl_tpu_torch.train_video_contrast_dis \\
        --config_file configs/visual_moco.yaml MODEL.AUG_FLAG True \\
        DATASET.SOURCE frames INPUT.PRE_LOAD shard \\
        DATASET.VISUAL_ROOT_DIR <store> DATASET.TRAIN_SPLIT <list> --max_steps 5

The regime is ``CONTRAST.MEM_TYPE``: ``moco`` (GCA-M with
``MODEL.AUG_FLAG True``), ``simsiam`` (``configs/visual_simsiam.yaml``;
GCA-S with the graph on) or ``bank`` (the instance-discrimination memory
bank, ``CROSS.CRITERION`` crossentropy or NCE, one row per clip of the
dataset).  ``CROSS.MODALITY`` other than ``visual`` (e.g. ``cross``) trains
CMC under moco or bank: two encoder + head stacks, the second on the clips'
temporal differences, each scored against the other's memory::

    python -m video_graph_ssl_tpu_torch.train_video_contrast_dis \\
        --config_file configs/visual_moco.yaml MODEL.AUG_FLAG True \\
        CROSS.MODALITY cross DATASET.SOURCE synthetic --max_steps 5

Data comes from ``build_video_contrastive_loader`` (synthetic clips, JPEG
frame folders or a shard store, ``python -m
video_graph_ssl_tpu_torch.build_shards``).  Runs live under
``run/<dataset>/<checkname>/experiment_NN`` (``utils/saver.py``), with a
checkpoint every ``CHECKPOINT.CHECKPOINT_INTERVAL`` epochs and at the last
one; ``CHECKPOINT.RESUME`` continues a run (``CHECKPOINT.FINETUNE`` takes
the state but restarts the epoch count), ``MODEL.PRETRAIN_PATH`` (with
``MODEL.PRETRAINED True``) warm-starts the backbone from a reference-named
``state_dict``, and SIGTERM finishes the step, writes
``checkpoint_preempt.pth.tar`` and exits 0.

``--device`` defaults to ``cuda``; when that is asked for and no GPU is
present the trainer raises, it never moves to the CPU by itself.

Several GPUs: one process per rank under ``torch.distributed``, each on
``cuda:LOCAL_RANK`` with its rows of every global batch
(``DATALOADER.BATCH_SIZE`` is global, as in the JAX package)::

    torchrun --nproc_per_node 4 -m video_graph_ssl_tpu_torch.train_video_contrast_dis \
        --config_file configs/visual_moco.yaml MODEL.AUG_FLAG True ...
    # or the reference's flags: one rank per visible card of each node
    python -m video_graph_ssl_tpu_torch.train_video_contrast_dis \
        --multiprocessing-distributed --world_size 1 --rank 0 \
        --dist-url tcp://localhost:23456 --config_file ...

``--world_size N --rank R --dist-url URL`` without
``--multiprocessing-distributed`` runs this process as rank R of N.
``--dist-backend`` is ``nccl`` by default (``gloo`` for CPU ranks, and for
ranks that share one card).  Only rank 0 writes checkpoints, telemetry and
the log; every rank reads a resumed checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import socket
import threading
import time
from typing import Callable, Dict, Optional

import torch
import torch.multiprocessing

from .config import cfg as default_cfg
from .data.build import build_video_contrastive_loader
from .data.pipeline import to_device
from .engine.build import create_pretrain_state
from .engine.pretrain import make_fused_pretrain_step
from .models.build import create_visual_model
from .models.wrappers import VisualEncoder
from .parallel import dist
from .solver.build import make_lr_scheduler
from .utils.checkpoint import (load_checkpoint_state, read_payload,
                               wait_for_async_checkpoints)
from .utils.meters import AverageMeter
from .utils.summary import creat_saver
from .utils.torch_names import detect_kind, port_backbone_names, rgb_stack

# --profile_dir traces steps 5 to 10 (both included) of the first epoch
PROFILE_STEPS = (5, 10)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Video contrastive pretraining on a GPU (PyTorch port)")
    parser.add_argument("--config_file", default="", type=str,
                        help="path to YAML config")
    add_dist_args(parser)
    parser.add_argument("--max_steps", default=0, type=int,
                        help="cap total steps, counted across epochs (0 = unlimited)")
    parser.add_argument("--profile_dir", default="", type=str,
                        help="write a torch.profiler trace of steps 5-10 of the "
                             "first epoch into this directory")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to train on (default: cuda)")
    parser.add_argument("opts", nargs="*",
                        help="config overrides: KEY VALUE ... (options may "
                             "come before or after them)")
    return parser


def add_dist_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The reference's DDP flags, which :func:`launch` reads (ignored under
    torchrun, whose environment gives the ranks)."""
    parser.add_argument("--rank", default=0, type=int,
                        help="node rank (with --multiprocessing-distributed), "
                             "else this process's rank")
    parser.add_argument("--world_size", default=1, type=int,
                        help="number of nodes (with --multiprocessing-distributed), "
                             "else of ranks")
    parser.add_argument("--dist-url", default="", type=str,
                        help="rendezvous: tcp://host:port or file://path (default "
                             "with --multiprocessing-distributed on one node: a "
                             "free localhost port)")
    parser.add_argument("--multiprocessing-distributed", action="store_true",
                        help="start one rank per visible card of this node")
    parser.add_argument("--dist-backend", default="nccl", type=str,
                        help="torch.distributed backend (nccl; gloo for CPU ranks "
                             "or ranks that share one card)")
    return parser


def resolve_device(name: str) -> torch.device:
    """The device to train on; under a process group a bare ``cuda`` is
    ``cuda:LOCAL_RANK``, made the current card."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device is available")
        if dist.is_distributed():
            if device.index is None:
                device = torch.device("cuda", dist.local_rank())
            torch.cuda.set_device(device)
    return device


def load_backbone_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference-named backbone ``state_dict`` from a torch file, by the
    JAX package's rule (``utils/ckpt_convert.py:load_backbone_init``): the
    ``state_dict`` envelope goes, the wrapper prefixes ``module.`` /
    ``encoder.`` / ``base_model.`` / ``model.`` are stripped while every key
    has one, then the subtree under ``encoder.base_model.`` or
    ``base_model.`` is kept where any key has it.  A CMC checkpoint
    (``model_1.``/``model_2.`` roots, ``torch_names.detect_kind``) gives its
    RGB stack's backbone.  So a bare backbone, a
    DDP-wrapped one and a whole pretrain checkpoint (heads included, as
    the port's ``Saver`` writes it) all give the backbone's own names
    (``base.N...``, ``layer1.0...``); the reference's names (S3DG, I3D, the
    ResNets, BN-Inception, Inception-v3) are mapped to the port's
    (``utils/torch_names.py``)."""
    obj = read_payload(path)
    sd = obj["state_dict"] if isinstance(obj, dict) and "state_dict" in obj else obj
    with contextlib.suppress(ValueError):   # a bare backbone has no wrapper roots
        if detect_kind(sd) == "cmc_pretrain":
            sd = rgb_stack(sd)
    changed = True
    while changed:
        changed = False
        for prefix in ("module.", "encoder.", "base_model.", "model."):
            if sd and all(k.startswith(prefix) for k in sd):
                sd = {k[len(prefix):]: v for k, v in sd.items()}
                changed = True
    for prefix in ("encoder.base_model.", "base_model."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
            break
    return port_backbone_names(sd)


class Trainer:
    """Counterpart of the JAX tool's Trainer: builds the loader, model,
    state, fused step, LR schedule and saver, then runs epochs.  Under a
    process group (initialised by the caller) it is one rank: it loads its
    rows of each global batch, and only rank 0 writes and prints."""

    def __init__(self, config, max_steps: int = 0, device: str = "cuda",
                 profile_dir: str = "", run_dir: str = "run"):
        self.cfg = config
        self.max_steps = int(max_steps)
        self.profile_dir = profile_dir
        self.device = resolve_device(device)
        # first: it refuses what is not ported before anything is built
        self.step_fn = make_fused_pretrain_step(config)
        self.is_main = dist.is_main()
        self.batch_slice = (dist.process_batch_slice(int(config.DATALOADER.BATCH_SIZE))
                            if dist.is_distributed() else None)
        # SIGTERM reaches each rank on its own: the ranks vote after every
        # step, on the host, so that all of them stop at the same step
        self.vote_group = dist.host_group()
        self.saver, self.writer = creat_saver(config, base_dir=run_dir)
        self.model, self.feat_dim = create_visual_model(config)
        self.train_loader, self.n_data = build_video_contrastive_loader(
            config, batch_slice=self.batch_slice)
        self.state = create_pretrain_state(config, self.model, self.device, self.n_data)
        self._load_pretrain_backbone()
        self.lr_fn = make_lr_scheduler(config)
        self.batch_size = int(config.DATALOADER.BATCH_SIZE)
        self.start_epoch = int(config.SOLVER.START_EPOCH)
        self.best_pred = 0.0
        self._resume()
        self.batch_time = AverageMeter()
        self.data_time = AverageMeter()
        self.losses = AverageMeter()
        self.top1 = AverageMeter()
        self.top5 = AverageMeter()
        # one record per printed (synchronised) step: epoch, i, data (the
        # wait on the loader), feed (pin and copy), step, loss; seconds
        self.history = []
        self._preempted = False

    def _on_sigterm(self, signum, frame):
        print("=> SIGTERM: checkpointing after the current step...", flush=True)
        self._preempted = True

    def _load_pretrain_backbone(self) -> None:
        """MODEL.PRETRAIN_PATH: a reference-named backbone state_dict, loaded
        strictly into the encoder's backbone and then into the EMA encoder's,
        which starts as a copy (reference: visual_wrappers.py:137-146); under
        CMC into both stacks' backbones, as in JAX."""
        path = str(self.cfg.MODEL.PRETRAIN_PATH)
        if not self.cfg.MODEL.PRETRAINED or path in ("", "none", "/"):
            return
        if not os.path.exists(path):
            raise RuntimeError(f"=> no pretrain backbone found at '{path}'")
        sd = load_backbone_state_dict(path)
        for model in (self.state.model, self.state.ema_model):
            if model is None:   # the bank and SimSiam have no EMA encoder
                continue
            for enc in (m for m in model.modules() if isinstance(m, VisualEncoder)):
                enc.base_model.load_state_dict(sd, strict=True)
        self._log(f"=> initialized backbone from '{path}' (MODEL.PRETRAIN_PATH)")

    def _resume(self) -> None:
        path = self.cfg.CHECKPOINT.RESUME
        if path and path != "none":
            if not os.path.exists(path):
                raise RuntimeError(f"=> no checkpoint found at '{path}'")
            meta = load_checkpoint_state(path, self.state)
            if not self.cfg.CHECKPOINT.FINETUNE:
                self.start_epoch = int(meta.get("epoch", 0))
                self.best_pred = float(meta.get("best_pred", 0.0))
            self._log(f"=> loaded checkpoint '{path}' (epoch {meta.get('epoch')})")

    def _log(self, line: str) -> None:
        if self.is_main:
            print(line, flush=True)

    def to_device(self, batch: dict) -> torch.Tensor:
        return to_device(batch["clips"], self.device)

    def index_of(self, batch: dict) -> Optional[torch.Tensor]:
        """The batch's dataset indices on the device, for the bank (which
        reads them as its rows); None for the other regimes."""
        if self.cfg.CONTRAST.MEM_TYPE != "bank":
            return None
        return to_device(batch["index"].astype("int64"), self.device)

    def train_step(self, raw_clips: torch.Tensor, lr: float,
                   index: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One fused step on a raw uint8 (B, 2, T, H, W, 3) device batch;
        ``index`` (B,) feeds the bank."""
        return self.step_fn(self.state, raw_clips, lr, index)

    def _at_max_steps(self, steps_done: int) -> bool:
        return bool(self.max_steps) and steps_done >= self.max_steps

    def train(self, epoch: int) -> None:
        for m in (self.batch_time, self.data_time, self.losses, self.top1, self.top5):
            m.reset()
        lr = self.lr_fn(epoch)
        n_iter = len(self.train_loader)
        print_freq = int(self.cfg.CHECKPOINT.PRINT_FREQ)
        bsz = self.batch_size
        profiling = bool(self.profile_dir) and epoch == self.start_epoch
        prof = None
        batches = self.train_loader.epoch(epoch)
        end = time.time()
        try:
            for i, batch in enumerate(batches):
                data_s = time.time() - end
                self.data_time.update(data_s)
                if profiling and i == PROFILE_STEPS[0]:
                    prof = torch.profiler.profile(activities=self._activities())
                    prof.start()
                t_feed = time.time()
                clips = self.to_device(batch)
                index = self.index_of(batch)
                feed_s = time.time() - t_feed
                metrics = self.train_step(clips, lr, index)
                if prof is not None and i == PROFILE_STEPS[1]:
                    self._stop_profile(prof)
                    prof = None
                if i % print_freq == 0 or i == n_iter - 1:
                    m = {k: float(v) for k, v in metrics.items()}   # device sync
                    self.losses.update(m["loss"], bsz)
                    if "top1" in m:   # SimSiam reports its loss only
                        self.top1.update(m["top1"], bsz)
                        self.top5.update(m["top5"], bsz)
                    self.batch_time.update(time.time() - end)
                    self.history.append(dict(epoch=epoch, i=i, data=data_s, feed=feed_s,
                                             step=self.batch_time.val, loss=m["loss"]))
                    self.writer.add_scalar("train/total_loss_iter", m["loss"],
                                           i + n_iter * epoch)
                    self._log(
                        f"Epoch: [{epoch}][{i}/{n_iter}], lr: {lr:.5f}\t"
                        f"Time {self.batch_time.val:.3f} ({self.batch_time.avg:.3f})\t"
                        f"Data {self.data_time.val:.3f} ({self.data_time.avg:.3f})\t"
                        f"Loss {self.losses.val:.4f} ({self.losses.avg:.4f})\t"
                        f"Prec@1 {self.top1.val:.3f} ({self.top1.avg:.3f})\t"
                        f"Prec@5 {self.top5.val:.3f} ({self.top5.avg:.3f})")
                end = time.time()
                if dist.any_rank(self._preempted, self.vote_group):
                    self._preempted = True
                    self._log("======>Preemption Checkpoint...")
                    self.saver.save_checkpoint(self.state, epoch, self.best_pred,
                                               filename="checkpoint_preempt.pth.tar")
                    return
                if self._at_max_steps(i + 1 + n_iter * epoch):
                    break
        finally:
            batches.close()       # stops the loader's threads on an early break
            if prof is not None:  # the epoch ended inside the traced steps
                self._stop_profile(prof)

        self.writer.add_scalar("train/loss", self.losses.avg, epoch)
        self.writer.add_scalar("train/top1_acc", self.top1.avg, epoch)
        self.writer.add_scalar("train/top5_acc", self.top5.avg, epoch)
        self.writer.add_scalar("lr", lr, epoch)

        interval = int(self.cfg.CHECKPOINT.CHECKPOINT_INTERVAL)
        last = int(self.cfg.SOLVER.MAX_EPOCHS) - 1
        if (epoch + 1) % interval == 0 or epoch == last:
            self._log("======>Saving Checkpoint...")
            self.saver.save_checkpoint(self.state, epoch + 1, self.best_pred,
                                       filename=f"checkpoint_{epoch + 1}.pth.tar")

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # the traced steps' work is done
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace_rank{dist.rank()}.json"
                            if dist.is_distributed() else "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}", flush=True)

    def run(self) -> None:
        # SIGTERM is caught only around the epochs, in the main thread
        main = threading.current_thread() is threading.main_thread()
        previous = signal.signal(signal.SIGTERM, self._on_sigterm) if main else None
        try:
            n_iter = len(self.train_loader)
            for epoch in range(self.start_epoch, int(self.cfg.SOLVER.MAX_EPOCHS)):
                self.train(epoch)
                if self._preempted or self._at_max_steps((epoch + 1) * n_iter):
                    break
        finally:
            if main:
                signal.signal(signal.SIGTERM, previous)
            # a save in flight commits while the process group still exists
            wait_for_async_checkpoints()
            self.writer.close()


def load_config(config_file: str = "", opts=()):
    """A clone of the default schema merged with a YAML file and overrides."""
    c = default_cfg.clone()
    if config_file:
        c.merge_from_file(config_file)
    c.merge_from_list(list(opts))
    c.freeze()
    return c


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_rank(args, body: Callable, rank: Optional[int] = None,
             world: Optional[int] = None, device: Optional[str] = None):
    """``body(config, args, device)`` as one process: alone (or inside a
    group the caller already joined), as a torchrun rank, or as rank
    ``rank`` of ``world`` at ``--dist-url``; a group joined here ends with
    the run.  Returns what ``body`` returns."""
    config = load_config(args.config_file, args.opts)
    grouped = dist.launched_by_torchrun() or world is not None
    if dist.launched_by_torchrun():
        dist.init_distributed(args.dist_backend)
    elif world is not None:
        dist.init_distributed(args.dist_backend, args.dist_url, world, rank)
    try:
        return body(config, args, device or args.device)
    finally:
        if grouped:
            torch.distributed.destroy_process_group()


def _spawned_rank(index: int, args, per_node: int, world: int, body: Callable) -> None:
    """torch.multiprocessing.spawn's entry: card ``index`` of this node."""
    device = args.device if args.device == "cpu" else f"cuda:{index}"
    run_rank(args, body, args.rank * per_node + index, world, device)


def launch(args, body: Callable):
    """Run ``body(config, args, device)`` on the ranks that ``args`` (the
    flags of :func:`add_dist_args`) or torchrun's environment give: one
    process, this process as one rank, or with ``--multiprocessing-distributed``
    one spawned rank per card of this node.  Returns ``body``'s result where
    this process ran it (None where it spawned the ranks)."""
    if dist.launched_by_torchrun():
        return run_rank(args, body)
    if args.multiprocessing_distributed:
        # the reference's launcher: --world_size nodes, --rank this node's
        per_node = torch.cuda.device_count() if args.device != "cpu" else 1
        if per_node < 1:
            raise RuntimeError("--multiprocessing-distributed: no CUDA device is available")
        if not args.dist_url:
            if args.world_size != 1:
                raise ValueError("--dist-url is needed across nodes")
            args.dist_url = f"tcp://localhost:{_free_port()}"
        torch.multiprocessing.spawn(_spawned_rank, args=(args, per_node,
                                                         per_node * args.world_size, body),
                                    nprocs=per_node)
        return None
    if args.world_size > 1:
        if not args.dist_url:
            raise ValueError("--world_size above 1 needs --dist-url")
        return run_rank(args, body, args.rank, args.world_size)
    return run_rank(args, body)


def train(config, args, device: str) -> None:
    """The pretrain body of :func:`launch`: one rank's Trainer run."""
    if dist.is_main():
        print(f"Running with config:\n{config}")
    Trainer(config, max_steps=args.max_steps, device=device,
            profile_dir=args.profile_dir).run()


def main(argv: Optional[list] = None) -> None:
    launch(get_parser().parse_intermixed_args(argv), train)


if __name__ == "__main__":
    main()
