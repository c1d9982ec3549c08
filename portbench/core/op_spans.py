"""Device time of the port's op-level spans: the ``vgs.*`` host ops that
``video_graph_ssl_tpu_torch/utils/tracing.py`` opens while a profiler
records (the stem, each batch norm, each max pool's forward and backward,
each graph block and its K1 and K2 calls).  They are function-scope
records, not user annotations, so they add no range to the device's
timeline and :func:`.trace.reduce_events` reads the same device events with
them as without.

Each device operation goes to one span at most, in this order:

1. its launch: the runtime call that launched it (``cudaLaunchKernel`` and
   kin, found by the operation's own correlation id), else its launching
   host op (by the linked correlation id) and that op's start.  The runtime
   call places a kernel launched straight from Python (K2's dx, K3/K4,
   through ``ctypes``) inside the span around the launch, where the
   enclosing host op, an autograd node, began before that span;
2. the innermost ``vgs.*`` span open on the launching thread at the
   launch, which takes the operation's time as its own;
3. where none is open and the launch lies inside an
   ``autograd::engine::evaluate_function`` event (the backward), that
   event's ``sequence_nr`` names the forward op it differentiates; the
   innermost span open at that forward op's start, under ``<span>.bwd``,
   takes the time.

A span's total holds its own time and its nested spans': an operation adds
to the total of every span open around it, and, in the backward, to the
``.bwd`` total of every span open around the forward op it differentiates
(``stem.bwd`` holds the stem's ``batch_norm.bwd``; ``graph_block.bwd``
holds K2's dx, whose own span is ``gcn_propagate``).  Device annotation
ranges (the phases' ``record_function`` spans, the optimizer's step) are
not operations.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Iterable, List, Tuple

import torch

PREFIX = "vgs."
EVALUATE = "autograd::engine::evaluate_function: "
BWD = ".bwd"


class _Nest:
    """Properly nested host intervals of one thread: :meth:`at` gives the
    labels of those open at a time, outermost first."""

    def __init__(self, intervals: List[Tuple[int, int, object]]):
        self.iv = sorted(intervals, key=lambda s: (s[0], -s[1]))
        self.starts = [s for s, _, _ in self.iv]
        self.parent, stack = [], []
        for k, (s, _, _) in enumerate(self.iv):
            while stack and self.iv[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(k)

    def at(self, t: int) -> list:
        # the last interval started by t; any interval open at t encloses it
        k = bisect.bisect_right(self.starts, t) - 1
        while k >= 0 and self.iv[k][1] <= t:
            k = self.parent[k]
        out = []
        while k >= 0:
            out.append(self.iv[k][2])
            k = self.parent[k]
        return out[::-1]


def attribute(events: Iterable) -> tuple:
    """(the entries of each span, and per device operation (name, ns, its
    own span or None, the spans whose totals it adds to))."""
    host, launches, fwd = {}, {}, {}
    spans, evals = defaultdict(list), defaultdict(list)
    calls, device = Counter(), []
    for e in events:
        name = e.name()
        if e.device_type() != torch.autograd.DeviceType.CPU:
            if not e.is_user_annotation():
                device.append((name, e.duration_ns(), e.correlation_id(),
                               e.linked_correlation_id()))
            continue
        th, s = e.start_thread_id(), e.start_ns()
        if name.startswith(PREFIX):
            spans[th].append((s, s + e.duration_ns(), name[len(PREFIX):]))
            calls[name[len(PREFIX):]] += 1
        elif name.startswith(EVALUATE):
            evals[th].append((s, s + e.duration_ns(), (e.fwd_thread_id(), e.sequence_nr())))
        elif e.linked_correlation_id() or name.startswith("cu"):
            # a CUDA runtime or driver call: its correlation id is the one
            # of the operation it launched, not an op's
            launches[e.correlation_id()] = (th, s)
        else:
            host[e.correlation_id()] = (th, s)
            if e.sequence_nr() >= 0:
                key = (th, e.sequence_nr())
                fwd[key] = min(fwd.get(key, s), s)
    span_at = {th: _Nest(iv) for th, iv in spans.items()}
    eval_at = {th: _Nest(iv) for th, iv in evals.items()}

    def open_spans(th, t) -> list:
        return span_at[th].at(t) if th in span_at else []

    def forward_spans(th, t) -> list:
        """The spans open at the start of the forward op that the
        innermost backward node open at ``t`` differentiates."""
        nodes = eval_at[th].at(t) if th in eval_at else []
        start = fwd.get(nodes[-1]) if nodes else None
        return [] if start is None else open_spans(nodes[-1][0], start)

    ops = []
    for name, dur, corr, linked in device:
        names, backward = [], []
        launch = launches.get(corr) or host.get(linked)
        if launch:
            th, t = launch
            names = open_spans(th, t)
            backward = [n + BWD for n in forward_spans(th, t)]
        own = (names or backward or [None])[-1]
        ops.append((name, dur, own, sorted(set(names + backward))))
    return calls, ops


def reduce_op_spans(events: Iterable, steps: int) -> dict:
    """Per traced step: ``op_ms``, device ms of each span's own operations
    (``<span>`` and ``<span>.bwd``); ``op_total_ms``, the same with the
    nested spans' operations; ``op_calls``, the entries of each span."""
    calls, ops = attribute(events)
    own, total = defaultdict(float), defaultdict(float)
    for _, dur, span, spans in ops:
        if span is not None:
            own[span] += dur
        for n in spans:
            total[n] += dur
    per = max(int(steps), 1)
    return {"op_ms": {k: v / 1e6 / per for k, v in own.items()},
            "op_total_ms": {k: v / 1e6 / per for k, v in total.items()},
            "op_calls": {k: v / per for k, v in calls.items()}}
