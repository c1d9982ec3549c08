"""Op-level spans and event counters of the port.

``span(name)`` marks where a layer's work happens (the stem, each batch
norm, each max pool's forward and backward, each graph block and its K1 and
K2 calls).  While ``torch.profiler`` records it is a host op named
``vgs.<name>`` (a ``RecordFunction`` of function scope, as torch's own ops
are): the trace holds it on the host, and the kernels launched inside it
are its own or its nested ops'.  Unlike a ``record_function``, a user
annotation, it adds no annotation range to the device's timeline, so a
reader that counts every device event as work sees the same device events
with spans as without.  Otherwise a span is a shared no-op context, which
costs one check of the profiler's flag (about 0.2 us on the host against
about 12 us for a ``record_function`` with no profiler).  So spans are on
exactly while a profiler runs: the trainer's ``--profile_dir``,
``profile_step.py``, the benchmark's traced steps.  Under ``torch.compile``
or ``torch.export`` a span is the no-op context, so a traced graph holds no
profiler op.

The counters count events of the hand-written kernels' wrappers (calls of
each kernel, copies of their operands) in one registry: ``count(name)``
adds, ``counters()`` reads (a name never counted reads 0),
``reset_counters()`` starts again.
"""

from __future__ import annotations

import contextlib
from collections import Counter

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "vgs."
OFF = contextlib.nullcontext()      # the shared no-op context
_COUNTS: Counter = Counter()


def span(name: str):
    """A host op named ``vgs.<name>`` while a profiler records, else a no-op
    context."""
    if not torch.autograd._profiler_enabled() or torch.compiler.is_compiling():
        return OFF
    return _RecordFunctionFast(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] += int(n)


def counters() -> Counter:
    """A copy of the counts since the last reset."""
    return Counter(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()
