"""Training telemetry: TensorBoard scalars plus a JSONL record (counterpart
of ``video_graph_ssl_tpu/utils/summary.py``).

``metrics.jsonl`` is always written, so runs are machine-readable without
TensorBoard; the tensorboardX writer is added only where tensorboardX is
importable.
"""

from __future__ import annotations

import json
import os
import time


def _summary_writer():
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter


class TensorboardSummary:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        writer = _summary_writer()
        self.writer = writer(logdir=directory) if writer is not None else None
        self._jsonl = open(os.path.join(directory, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), int(step))
        self._jsonl.write(json.dumps(
            {"t": time.time(), "tag": tag, "value": float(value),
             "step": int(step)}) + "\n")
        self._jsonl.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()
        self._jsonl.close()


class NullSummary:
    """The writer of a rank other than 0: records nothing."""

    def add_scalar(self, tag: str, value, step: int):
        pass

    def close(self):
        pass


def creat_saver(cfg, base_dir: str = "run"):
    """Saver + writer bundle (reference: lib/utils/build.py:4-10; the
    reference name 'creat_saver' is kept for interface parity).  Under
    several ranks only rank 0 writes telemetry."""
    from .saver import Saver

    saver = Saver(cfg, base_dir=base_dir)
    saver.save_experiment_config()
    writer = TensorboardSummary(saver.experiment_dir) if saver.writes else NullSummary()
    return saver, writer
