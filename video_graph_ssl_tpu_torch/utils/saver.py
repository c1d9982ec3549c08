"""Experiment directory management + best-model promotion (counterpart of
``video_graph_ssl_tpu/utils/saver.py``).

Counterpart of lib/utils/saver.py:7-58: runs live in
``run/<dataset>/<checkname>/experiment_N``; ``save_checkpoint`` writes the
state and promotes ``model_best`` by comparing ``best_pred.txt`` across
sibling experiments; ``save_experiment_config`` dumps ``parameters.txt``.
Checkpoints are ``torch.save`` files (``utils/checkpoint.py``), or with
``TPU.CKPT_BACKEND orbax`` sharded ``torch.distributed.checkpoint``
directories ``<name>.dcp`` where JAX writes ``<name>.orbax`` (asynchronous
with ``TPU.ASYNC_CKPT``).  Under several ranks the state is the same on
every rank, so rank 0 alone owns the experiment directory, the metadata
and the promotion of ``model_best``; every rank calls
:meth:`Saver.save_checkpoint`.  A file is written by rank 0 alone, a
directory by all ranks together (each writes its share) over a gloo group
that nothing else uses; the others wait at a barrier until the checkpoint
is complete (an async directory: until its snapshot is taken).  The
trainers drain a save still in flight before they return, so it commits
before the process group ends.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Any, Dict, Optional

import torch.distributed as tdist

from ..parallel import dist
from .checkpoint import (DCP_SUFFIX, save_checkpoint_orbax, save_checkpoint_state,
                         wait_for_async_checkpoints)


class Saver:
    def __init__(self, cfg, base_dir: str = "run"):
        self.cfg = cfg
        # JAX's saver: "orbax" is the sharded backend, anything else msgpack
        self.sharded = str(cfg.TPU.CKPT_BACKEND) == "orbax"
        self.async_save = bool(cfg.TPU.ASYNC_CKPT)
        self.directory = os.path.join(base_dir, cfg.DATASET.NAME,
                                      cfg.CHECKPOINT.CHECKNAME)
        self.writes = dist.is_main()
        self.experiment_dir = None
        # the sharded backend's ranks write together over a gloo group of
        # its own: an async save's collectives run in a background thread,
        # beside the step's and the barrier's on the default group
        self.group = (tdist.new_group(backend="gloo")
                      if self.sharded and dist.world_size() > 1 else None)
        run_id = None
        if self.writes:
            runs = sorted(glob.glob(os.path.join(self.directory, "experiment_*")),
                          key=lambda p: int(p.split("_")[-1]))
            run_id = int(runs[-1].split("_")[-1]) + 1 if runs else 0
        if self.sharded and dist.world_size() > 1:
            shared = [run_id]
            tdist.broadcast_object_list(shared, 0, group=self.group)
            run_id = shared[0]
        if run_id is None:
            return
        self.experiment_dir = os.path.join(self.directory,
                                           f"experiment_{run_id:02d}")
        if self.writes:
            os.makedirs(self.experiment_dir, exist_ok=True)

    def checkpoint_path(self, filename: str) -> str:
        return os.path.join(self.experiment_dir, filename)

    def save_checkpoint(self, state, epoch: int, best_pred: float = 0.0,
                        is_best: bool = False,
                        filename: str = "checkpoint.pth.tar",
                        extra: Optional[Dict[str, Any]] = None) -> str:
        """Write the checkpoint; on ``is_best`` record best_pred and promote
        it to ``model_best`` when it beats every sibling experiment
        (reference: saver.py:20-43).  Returns the path (None on a rank
        other than 0, which only waits for rank 0's write, or writes its
        share of a directory)."""
        path = None
        if self.sharded:
            path = self.checkpoint_path(filename.replace(".pth.tar", DCP_SUFFIX))
            save_checkpoint_orbax(path, state, epoch, best_pred, extra,
                                  async_save=self.async_save, process_group=self.group)
            if self.writes:
                self._best(path, best_pred, is_best)
        elif self.writes:
            path = self.checkpoint_path(filename)
            save_checkpoint_state(path, state, epoch, best_pred, extra)
            self._best(path, best_pred, is_best)
        dist.barrier()
        return path if self.writes else None

    def _best(self, path: str, best_pred: float, is_best: bool) -> None:
        """On ``is_best``: best_pred.txt, and ``path`` promoted to
        ``model_best`` (a directory drained, copied and its meta file
        beside it, as JAX's saver does) where it beats every sibling."""
        if is_best:
            with open(self.checkpoint_path("best_pred.txt"), "w") as f:
                f.write(str(best_pred))
            previous = []
            for run_dir in glob.glob(os.path.join(self.directory, "experiment_*")):
                bp = os.path.join(run_dir, "best_pred.txt")
                if os.path.exists(bp) and run_dir != self.experiment_dir:
                    with open(bp) as f:
                        try:
                            previous.append(float(f.readline()))
                        except ValueError:
                            pass
            if not previous or best_pred > max(previous):
                if os.path.isdir(path):
                    dst = os.path.join(self.directory, "model_best" + DCP_SUFFIX)
                    wait_for_async_checkpoints()
                    if os.path.isdir(dst):
                        shutil.rmtree(dst)
                    shutil.copytree(path, dst)
                    shutil.copyfile(path + ".meta.json", dst + ".meta.json")
                else:
                    shutil.copyfile(path, os.path.join(self.directory,
                                                       "model_best.pth.tar"))

    def save_experiment_config(self) -> None:
        """Dump the full config (reference writes parameters.txt,
        saver.py:45-58); rank 0 only."""
        if not self.writes:
            return
        with open(self.checkpoint_path("parameters.txt"), "w") as f:
            f.write(self.cfg.dump())
