"""Pretraining driver: the program's ``Trainer.train_step`` (the fused GCA
MoCo step of ``engine/pretrain.py``) on raw uint8 clips made on the device.

Set-up builds the ``Trainer`` from the cell's settings (``MODEL.SEED`` the
run's seed, its run directory under ``TMPDIR``), loads the benchmark's
weights into its query encoder, weights drawn apart into its EMA encoder (so
each step moves the EMA by (1 - alpha)(query - EMA), far above rounding),
the benchmark's queue into its memory, and makes a pool of raw batches on
the device.  The first ``check_steps`` steps, through the same call and pool
as the window, are the warm-up and the readings that the check compares:
each step's loss, the first gradient as the optimizer gets it (a step
pre-hook), every BN's running variance after the first step, each leaf's
change in both encoders and the keys put into the queue.  Then the window
(``core/window.py``): steps until ``seconds`` have passed, the metrics read
to the host every ``CHECKPOINT.PRINT_FREQ`` steps and the ranks' stop vote
after each step, as ``Trainer.train`` does.  With ``trace``,
``trace_steps`` more steps run under the profiler.  After the peak memory is
read and the program's state is freed, the plain reference repeats the first
steps and the readings are compared.

``ranks`` above 1 in the traffic runs one process per card through the
program's own launcher, each with its rows of every global batch; the
metrics are the global batch's, and rank 0 checks its state against the
one-process reference.
"""

from __future__ import annotations

import gc
import math
import shutil
import tempfile

import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from portbench.core.trace import trace_steps
from portbench.core.window import Opts, end_to_end, measure_window, run_body  # noqa: F401
from portbench.metrics._classes import CLASSES
from portbench.reference.compare import compare
from portbench.reference.models import build_model, make_queue, make_weights, weight_specs
from portbench.reference.pretrain import KEY_ENCODER, bn_running_vars, run_moco

# the record_function spans of the program's MoCo step
# (``engine/pretrain.py:REGIME_PHASES["moco"]``)
SPANS = ("augment", "key_pass", "query_pass", "backward", "optimizer", "enqueue_ema")
PASSES = {"moco": {"forward": 2, "backward": 1}}


def make_pool(seed: int, n: int, shape, device) -> torch.Tensor:
    """``n`` raw uint8 batches (n, *shape) from ``seed``, on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2_654_435_761 + 41) & 0x7FFF_FFFF_FFFF_FFFF)
    return torch.randint(0, 256, (n, *shape), generator=g, device=device, dtype=torch.uint8)


def batch_shape(settings: dict) -> tuple:
    """(B, 2, T, H, W, 3) of a raw global batch at ``INPUT.SCALE_SIZE``."""
    h, w = settings["INPUT.SCALE_SIZE"]
    return (int(settings["DATALOADER.BATCH_SIZE"]), 2, int(settings["INPUT.VIDEO_LENGTH"]),
            int(h), int(w), 3)


def overrides(settings: dict, seed: int) -> list:
    opts = []
    for k, v in {**settings, "MODEL.SEED": int(seed), "DATASET.SOURCE": "synthetic"}.items():
        opts += [k, v]
    return opts


def reference_weights(settings: dict, seed: int, device) -> tuple:
    """The benchmark's starting weights of the query and the EMA encoder."""
    with torch.device("meta"):
        specs = weight_specs(build_model(settings["MODEL.BACKBONE"], settings["GRAPH.AUG_POINTS"],
                                         int(settings["CROSS.FEAT_DIM"])))
    return (make_weights(specs, seed, device),
            make_weights(specs, seed, device, encoder=KEY_ENCODER))


@torch.no_grad()
def load_inputs(state, w0: dict, k0: dict, queue0: torch.Tensor) -> None:
    """The benchmark's weights into the program's query encoder (``w0``) and
    EMA encoder (``k0``), its queue into the program's memory; BN statistics,
    optimizer state and the step count as a new run has them."""
    for model, weights in ((state.model, w0), (state.ema_model, k0)):
        params = dict(model.named_parameters())
        if set(params) != set(weights):
            raise ValueError("the program's parameters differ from the reference's: "
                             f"{sorted(set(params) ^ set(weights))[:8]}")
        for n, p in params.items():
            p.copy_(weights[n])
        for n, b in model.named_buffers():
            if n.endswith("running_mean"):
                b.zero_()
            elif n.endswith("running_var"):
                b.fill_(1.0)
    state.contrast.queue.copy_(queue0)
    state.contrast.ptr = 0
    state.optimizer.state.clear()
    state.step = 0


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


class FirstGradient:
    """Each leaf's norm of the gradient that the optimizer's first step gets
    (after any clipping), read by a global optimizer step pre-hook, so the
    reading does not depend on how the optimizer keeps its state."""

    def __init__(self, model: torch.nn.Module):
        self.model, self.norms = model, None
        self.handle = register_optimizer_step_pre_hook(self._hook)

    def _hook(self, optimizer, args, kwargs) -> None:
        if self.norms is None:
            self.norms = {n: _norm(p.grad) for n, p in self.model.named_parameters()
                          if p.grad is not None}

    def close(self) -> None:
        self.handle.remove()


@torch.no_grad()
def changes(model: torch.nn.Module, start: dict) -> dict:
    """Each leaf's norm of its change from ``start`` (host copies)."""
    return {n: _norm(p.detach().cpu() - start[n]) for n, p in model.named_parameters()}


def readings(state, step, w0: dict, k0: dict, settings: dict, n: int) -> dict:
    """Run ``step(k)`` for the first ``n`` steps and read what the check
    compares: each loss, the first gradient, every BN's running variance in
    both encoders after the first step, each leaf's change in both encoders
    from ``w0`` and ``k0`` (host copies), the keys."""
    out = {"loss": []}
    grad = FirstGradient(state.model)
    try:
        for k in range(n):
            out["loss"].append(float(step(k)["loss"]))
            if k == 0:
                out["bn"] = {"model": bn_running_vars(state.model),
                             "ema": bn_running_vars(state.ema_model)}
    finally:
        grad.close()
    out["grad"] = grad.norms
    out["delta"] = changes(state.model, w0)
    out["ema_delta"] = changes(state.ema_model, k0)
    b = int(settings["DATALOADER.BATCH_SIZE"])
    out["keys"] = state.contrast.queue[:n * b].detach().float().cpu()
    return out


def body(config, cell, opts: Opts, device: str, rank: int, world: int):
    """One process's run (one rank's under a process group), on its rows of
    each global batch; returns the window's numbers and the check."""
    from video_graph_ssl_tpu_torch.parallel import dist
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer

    settings, seed, traffic = cell.settings, int(opts.seed), cell.traffic
    b = int(settings["DATALOADER.BATCH_SIZE"])
    rows = slice(rank * b // world, (rank + 1) * b // world)
    run_dir = tempfile.mkdtemp(prefix="portbench_run_")
    trainer = Trainer(config, device=device, run_dir=run_dir)
    dev = trainer.device
    w0, k0 = reference_weights(settings, seed, dev)
    queue0 = make_queue(seed, int(settings["CONTRAST.NCE_K"]), int(settings["CROSS.FEAT_DIM"]), dev)
    load_inputs(trainer.state, w0, k0, queue0)
    # host copies for the readings: the benchmark's own tensors stay off the card's peak
    w0, k0 = ({n: t.cpu() for n, t in w.items()} for w in (w0, k0))
    del queue0
    pool = make_pool(seed, int(traffic["pool_batches"]), batch_shape(settings), dev)
    mine = pool[:, rows]
    step = trainer.train_step if opts.wrap_step is None else opts.wrap_step(trainer)
    lr = trainer.lr_fn(trainer.start_epoch)
    print_freq = int(settings["CHECKPOINT.PRINT_FREQ"])
    n_pool = pool.shape[0]
    read = {"failed": 0}

    def one(i: int) -> None:
        metrics = step(mine[i % n_pool], lr)
        if i % print_freq == 0:                       # the trainer's printed step
            vals = {k: float(v) for k, v in metrics.items()}
            read["failed"] += int(not math.isfinite(vals["loss"]))

    # set-up's steps: the warm-up, and the readings the check compares
    n_check = int(traffic["check_steps"])
    prog = readings(trainer.state, lambda k: step(mine[k % n_pool], lr), w0, k0, settings,
                    n_check)
    del w0, k0
    dist.barrier()
    win = measure_window(one, n_check, opts.seconds, dev,
                         lambda passed: dist.any_rank(passed, trainer.vote_group))
    # b is the global batch: every rank steps through its rows of it
    out = {"steps": win["steps"], "window_s": win["window_s"],
           "setup_s": win["t_open"] - opts.t_start, "intervals_ms": win["intervals_ms"],
           "units_per_step": b}
    if opts.trace:
        out["summary"] = trace_steps(lambda k: one(win["next"] + k), int(traffic["trace_steps"]),
                                     dev, SPANS, CLASSES)
        out["summary"]["untraced"] = {"steps": win["steps"], "window_s": win["window_s"]}
    out["failed"] = read["failed"]
    trainer.writer.close()
    shutil.rmtree(run_dir, ignore_errors=True)
    del trainer, step, mine, one
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out, lambda: check(cell, seed, pool, prog, n_check)


def check(cell, seed: int, pool: torch.Tensor, prog: dict, steps: int) -> dict:
    """The reference's first steps (TF32 off) against the program's readings."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = run_moco(cell.settings, seed, pool, steps)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return compare(prog, ref, cell.config)


def run(cell, opts: Opts) -> dict:
    """The cell's run: the window's numbers, the trace's summary with
    ``trace``, the peak, and the compared numbers."""
    if cell.settings["CONTRAST.MEM_TYPE"] != "moco":
        raise ValueError("the pretrain driver checks the MoCo regime only")
    out = run_body(cell, opts, body, overrides(cell.settings, opts.seed))
    out["metrics"] = end_to_end(out, "clips_per_s")
    if "summary" in out:
        out["summary"].update(settings=cell.settings, ranks=cell.ranks, regime="moco",
                              passes=PASSES["moco"])
    return out
