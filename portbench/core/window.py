"""What every driver's run shares, whatever the regime: the run's options,
the measured window with its step-end marks, the ranks' launch through the
program's own launcher, the peak, and the end-to-end numbers of the window.

A driver brings a ``body(config, cell, opts, device, rank, world)`` that
builds the program, runs its set-up and :func:`measure_window`, frees the
program's state and returns ``(out, check)``: ``out`` with at least
``steps``, ``window_s``, ``setup_s``, ``intervals_ms``, ``units_per_step``
and ``failed``, and ``check()`` the comparison with the reference.
:func:`run_body` runs it on the cell's ranks, reads the peak, then runs
``check`` on rank 0 into ``numbers``, so the reference never sets the peak.
"""

from __future__ import annotations

import argparse
import json
import shutil
import socket
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import torch

from . import stats
from .result import forbidden_modules


@dataclass
class Opts:
    seed: int
    seconds: float
    trace: bool
    t_start: float                       # perf_counter() at process start
    device: str = "cuda"
    backend: str = "nccl"
    # tests: wraps the program's step, to plant a fault underneath a run
    wrap_step: Optional[Callable] = None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Marks:
    """Step-end marks: CUDA events on the compute stream, read after the
    window; on the CPU the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return stats.intervals_from_marks([t * 1e3 for t in self.marks])


def measure_window(one: Callable[[int], None], start: int, seconds: float,
                   device: torch.device, stop: Callable[[bool], bool] = bool) -> dict:
    """``one(i)`` for i = start, start + 1, ... until ``seconds`` have passed
    (``stop(passed)`` is the ranks' vote on it after each step), a
    synchronise opening and closing the window and a mark at each step's
    end.  Returns ``steps``, ``window_s``, ``intervals_ms`` and ``next``, the
    index of the step after the window."""
    marks = Marks(device)
    sync(device)
    t_open = time.perf_counter()
    marks.mark()
    i = start
    while True:
        one(i)
        marks.mark()
        i += 1
        if stop(time.perf_counter() - t_open >= seconds):
            break
    sync(device)
    window_s = time.perf_counter() - t_open
    return {"steps": i - start, "window_s": window_s, "t_open": t_open,
            "intervals_ms": marks.intervals_ms(), "next": i}


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def end_to_end(out: dict, rate_name: str) -> dict:
    """The window's end-to-end numbers: ``rate_name`` (units of work over the
    whole window), the step tail, the peak and the set-up."""
    return {
        rate_name: stats.rate(out["steps"] * out["units_per_step"], out["window_s"]),
        "step_ms_p90": stats.percentile(out["intervals_ms"], 90),
        "peak_mem_gib": out["peak_bytes"] / 2 ** 30,
        "setup_s": out["setup_s"],
    }


def run_body(cell, opts: Opts, body: Callable, overrides: list) -> dict:
    """``body`` in this process, or with ``ranks`` above 1 in the traffic on
    one process per rank; rank 0's result with the peak of the fullest card
    and every rank's loaded forbidden modules."""
    if cell.ranks > 1:
        return _run_ranks(cell, opts, body, overrides)
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    out, check = body(load_config("", overrides), cell, opts, opts.device, 0, 1)
    out["peak_bytes"] = peak_bytes(torch.device(opts.device))
    out["numbers"] = check()
    out["forbidden"] = forbidden_modules()
    return out


def _rank_entry(config, args, device):
    from video_graph_ssl_tpu_torch.parallel import dist

    r = dist.rank()
    out, check = args.body(config, args.cell, args.run_opts, device, r, dist.world_size())
    peak = torch.tensor([float(peak_bytes(torch.device(device)))], dtype=torch.float64)
    torch.distributed.all_reduce(peak, op=torch.distributed.ReduceOp.MAX,
                                 group=dist.host_group())
    out["peak_bytes"] = int(peak.item())
    if r == 0:
        out["numbers"] = check()
    out["forbidden"] = forbidden_modules()
    with open(Path(args.out_dir) / f"rank{r}.json", "w") as f:
        json.dump(out, f, default=_jsonable)


def _jsonable(x):
    if isinstance(x, torch.Tensor):
        return x.tolist()
    if isinstance(x, tuple):
        return list(x)
    raise TypeError(type(x))


def _spawned(index: int, args) -> None:
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import run_rank

    device = "cpu" if args.device == "cpu" else f"cuda:{index}"
    run_rank(args, _rank_entry, index, args.world, device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(cell, opts: Opts, body: Callable, overrides: list) -> dict:
    """One process per rank through the program's launcher
    (``train_video_contrast_dis.run_rank``); the parent gathers rank 0's
    result and every rank's loaded modules."""
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="portbench_ranks_")
    args = argparse.Namespace(config_file="", opts=overrides, dist_backend=opts.backend,
                              device=opts.device, dist_url=f"tcp://localhost:{_free_port()}",
                              world=cell.ranks, cell=cell, run_opts=opts, out_dir=out_dir,
                              body=body)
    mp.start_processes(_spawned, args=(args,), nprocs=cell.ranks, join=True,
                       start_method="spawn")
    outs = []
    for r in range(cell.ranks):
        with open(Path(out_dir) / f"rank{r}.json") as f:
            outs.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    out = outs[0]
    out["forbidden"] = sorted({m for o in outs for m in o["forbidden"]})
    out["numbers"] = {k: tuple(v) for k, v in out["numbers"].items()}
    return out
