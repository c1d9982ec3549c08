"""Experiment directory management + best-model promotion (counterpart of
``video_graph_ssl_tpu/utils/saver.py``).

Counterpart of lib/utils/saver.py:7-58: runs live in
``run/<dataset>/<checkname>/experiment_N``; ``save_checkpoint`` writes the
state and promotes ``model_best`` by comparing ``best_pred.txt`` across
sibling experiments; ``save_experiment_config`` dumps ``parameters.txt``.
Checkpoints are ``torch.save`` files (``utils/checkpoint.py``); the JAX
package's sharded orbax backend (``TPU.CKPT_BACKEND orbax``) is not ported.
Under several ranks the state is the same on every rank, so rank 0 alone
owns the experiment directory and writes; every rank calls
:meth:`Saver.save_checkpoint`, and the others wait there at a barrier until
the file is complete.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Any, Dict, Optional

from ..parallel import dist
from .checkpoint import save_checkpoint_state


class Saver:
    def __init__(self, cfg, base_dir: str = "run"):
        backend = str(cfg.TPU.CKPT_BACKEND)
        if backend != "msgpack":
            raise NotImplementedError(
                f"TPU.CKPT_BACKEND {backend} is not ported; the port writes "
                "single-file torch.save checkpoints (TPU.CKPT_BACKEND msgpack)")
        self.cfg = cfg
        self.directory = os.path.join(base_dir, cfg.DATASET.NAME,
                                      cfg.CHECKPOINT.CHECKNAME)
        self.writes = dist.is_main()
        self.experiment_dir = None
        if not self.writes:
            return
        runs = sorted(glob.glob(os.path.join(self.directory, "experiment_*")),
                      key=lambda p: int(p.split("_")[-1]))
        run_id = int(runs[-1].split("_")[-1]) + 1 if runs else 0
        self.experiment_dir = os.path.join(self.directory,
                                           f"experiment_{run_id:02d}")
        os.makedirs(self.experiment_dir, exist_ok=True)

    def checkpoint_path(self, filename: str) -> str:
        return os.path.join(self.experiment_dir, filename)

    def save_checkpoint(self, state, epoch: int, best_pred: float = 0.0,
                        is_best: bool = False,
                        filename: str = "checkpoint.pth.tar",
                        extra: Optional[Dict[str, Any]] = None) -> str:
        """Write the checkpoint; on ``is_best`` record best_pred and promote
        it to ``model_best.pth.tar`` when it beats every sibling experiment
        (reference: saver.py:20-43).  Returns the path (None on a rank
        other than 0, which only waits for rank 0's write)."""
        path = None
        if self.writes:
            path = self._write(state, epoch, best_pred, is_best, filename, extra)
        dist.barrier()
        return path

    def _write(self, state, epoch, best_pred, is_best, filename, extra) -> str:
        path = self.checkpoint_path(filename)
        save_checkpoint_state(path, state, epoch, best_pred, extra)
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
                shutil.copyfile(path, os.path.join(self.directory,
                                                   "model_best.pth.tar"))
        return path

    def save_experiment_config(self) -> None:
        """Dump the full config (reference writes parameters.txt,
        saver.py:45-58); rank 0 only."""
        if not self.writes:
            return
        with open(self.checkpoint_path("parameters.txt"), "w") as f:
            f.write(self.cfg.dump())
