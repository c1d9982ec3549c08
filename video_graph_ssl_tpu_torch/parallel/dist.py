"""Process groups for multi-GPU training (counterpart of
``video_graph_ssl_tpu/parallel/mesh.py``).

The JAX package is one controller over a device mesh: XLA inserts the
collectives of a sharded step.  The port runs one process per rank under
``torch.distributed`` and calls them itself:

| JAX (sharded ``jit``)                        | the port                                  |
|----------------------------------------------|-------------------------------------------|
| gradient ``psum`` of the sharded loss        | ``DistributedDataParallel`` (mean)        |
| BN statistics over the global batch          | ``parallel/sync_bn.py``                   |
| the global key batch at the enqueue          | :func:`all_gather_rows`                   |
| replicated params, EMA, queue                | same seed on every rank, checked once     |
| ``process_batch_slice`` -> ``Loader``        | :func:`process_batch_slice`               |
| eval: ``pad_batch_to_multiple``, sharded fn  | :func:`eval_over_ranks`                   |

Without a process group every function here is the one-process identity:
``rank() == 0``, ``world_size() == 1``, gathers return their input, and
:func:`barrier` returns at once.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# torchrun's environment (env:// rendezvous)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT = datetime.timedelta(minutes=10)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_main() -> bool:
    return rank() == 0


def local_rank() -> int:
    """This process's rank on its host: torchrun's ``LOCAL_RANK``, else the
    global rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def launched_by_torchrun() -> bool:
    return all(v in os.environ for v in TORCHRUN_VARS)


def init_distributed(backend: str, init_method: Optional[str] = None,
                     world: Optional[int] = None, rank_: Optional[int] = None,
                     timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join the default process group: from torchrun's environment when no
    ``init_method`` is given, else at ``init_method`` (``tcp://host:port``
    or ``file://path``) as rank ``rank_`` of ``world``.  A failed
    rendezvous raises."""
    if is_distributed():
        raise RuntimeError("a default process group is already initialised")
    if init_method is None:
        if not launched_by_torchrun():
            raise RuntimeError("no init method given and no torchrun environment "
                               f"({', '.join(TORCHRUN_VARS)})")
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        if world is None or rank_ is None:
            raise ValueError("an explicit init method needs world and rank")
        dist.init_process_group(backend, init_method=init_method, world_size=int(world),
                                rank=int(rank_), timeout=timeout)


def process_batch_slice(global_batch: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of every global batch that this rank owns: rank r
    of W takes ``[r * B / W, (r + 1) * B / W)``; raises on an unequal
    share."""
    w, r = world_size(), rank()
    if int(global_batch) % w:
        raise ValueError(f"global batch {global_batch} does not split into "
                         f"{w} equal per-rank shares")
    per = int(global_batch) // w
    return r * per, (r + 1) * per


@torch.no_grad()
def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated on dim 0 in rank order (no gradient);
    ``x`` itself without a group of more than one rank."""
    if world_size() == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=0)


def eval_over_ranks(fn: Callable[[np.ndarray], torch.Tensor],
                    batch: np.ndarray) -> torch.Tensor:
    """``fn(batch)`` with the rows shared out over the ranks, as the JAX
    tools shard an eval batch over the mesh: the host batch is padded to a
    multiple of the world size by repeating its last row (JAX
    ``pad_batch_to_multiple``), each rank runs ``fn`` on its equal share,
    the outputs are gathered in rank order and cut back to the batch's
    rows.  Every rank returns the whole output; ``fn(batch)`` itself
    without a group of more than one rank."""
    w = world_size()
    if w == 1:
        return fn(batch)
    n = len(batch)
    pad = (-n) % w
    if pad:
        batch = np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)])
    per = len(batch) // w
    return all_gather_rows(fn(batch[rank() * per:(rank() + 1) * per]))[:n]


@torch.no_grad()
def mean_over_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over ranks (each rank holds an equal share of
    the global batch, so this is the global batch's mean)."""
    if world_size() == 1:
        return metrics
    names = list(metrics)
    v = torch.stack([metrics[n].float() for n in names])
    dist.all_reduce(v)
    v /= world_size()
    return dict(zip(names, v.unbind(0)))


@torch.no_grad()
def average_(tensors: Iterable[torch.Tensor]) -> None:
    """Replace each tensor by its mean over ranks, in place (one collective
    for all; the tensors share a dtype)."""
    if world_size() == 1:
        return
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world_size()
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


@torch.no_grad()
def check_replicated(tensors: Iterable[torch.Tensor], what: str) -> None:
    """Broadcast rank 0's tensors and raise on any rank whose own differ
    (bit for bit)."""
    if world_size() == 1:
        return
    bad = 0
    for t in tensors:
        ref = t.detach().clone()
        dist.broadcast(ref, 0)
        bad += int(not torch.equal(ref, t))
    flag = torch.tensor([bad], dtype=torch.int64, device=_collective_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    if int(flag):
        raise RuntimeError(f"{what} differ between ranks ({bad} tensors on rank {rank()})")


def any_rank(flag: bool, group=None) -> bool:
    """True on every rank when ``flag`` is true on any (a host-side vote over
    ``group``, which must take CPU tensors)."""
    if world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def host_group():
    """A group for votes on CPU tensors: the default group when it is gloo's,
    else a new gloo group of all ranks (every rank must call this)."""
    if world_size() == 1 or dist.get_backend() == "gloo":
        return None
    return dist.new_group(backend="gloo")


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def _collective_device() -> torch.device:
    """Where the default group's tensors must live (NCCL: the current card)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
