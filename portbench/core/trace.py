"""Reduce a ``torch.profiler`` trace of a few steps to the summary that the
per-layer metric readers take.

Every device operation (kernel, copy, fill) is attributed to the span that
was open on the host when the operation was launched: the launching op's
host start falls inside one of the ``record_function`` spans of the step.
The backward's ops run on the autograd engine's thread while the main
thread waits inside the ``backward`` span, so the attribution goes by host
time, not by thread.  Busy time is the union of the device intervals; idle
gaps are labelled by the span and op that launched the operation which
ended them.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Iterable, List, Sequence, Tuple

import torch

from .stats import union_length
from .window import sync


def kineto_events(prof) -> list:
    try:
        return list(prof.profiler.kineto_results.events())
    except AttributeError as e:
        raise RuntimeError(f"this torch.profiler has no kineto events: {e}") from e


def classify(name: str, classes: Sequence[Tuple[str, str]]) -> str:
    low = name.lower()
    for label, pattern in classes:
        if re.search(pattern, low):
            return label
    return "other"


def _span_at(spans: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    """The span open at host time ``t`` (the spans of a step do not overlap)."""
    i = bisect.bisect_right(starts, t) - 1
    return spans[i][2] if i >= 0 and t < spans[i][1] else "other"


def reduce_events(events: Iterable, span_names: Sequence[str],
                  classes: Sequence[Tuple[str, str]], steps: int, top: int = 10) -> dict:
    """The summary of ``steps`` traced steps: per step, device ms by span and
    by kernel class; the busy time (s); the ``top`` device operations and idle
    gaps (s, over all the traced steps)."""
    spans, host_ops, device = [], {}, []
    names = set(span_names)
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name() in names:
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            else:
                host_ops[e.correlation_id()] = (e.start_ns(), e.name())
        elif e.name() not in names:            # the spans' device annotation ranges
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                           e.linked_correlation_id()))
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    spans.sort()
    starts = [s for s, _, _ in spans]
    span_ms, class_ms, op_s = defaultdict(float), defaultdict(float), defaultdict(float)
    launched_by = []
    for s, e, name, corr in device:
        host = host_ops.get(corr)
        span = _span_at(spans, starts, host[0]) if host else "other"
        span_ms[span] += (e - s) / 1e6
        class_ms[classify(name, classes)] += (e - s) / 1e6
        op_s[name] += (e - s) / 1e9
        launched_by.append(f"{span}/{host[1]}" if host else "unattributed")
    order = sorted(range(len(device)), key=lambda i: device[i][0])
    gaps, end = defaultdict(float), None
    for i in order:
        s, e = device[i][0], device[i][1]
        if end is not None and s > end:
            gaps[launched_by[i]] += (s - end) / 1e9
        end = e if end is None else max(end, e)
    busy_s = union_length((s, e) for s, e, _, _ in device) / 1e9
    per_step = max(int(steps), 1)
    return {
        "steps": int(steps),
        "busy_s": busy_s,
        "device_ops": len(device) / per_step,
        "span_ms": {k: v / per_step for k, v in span_ms.items()},
        "class_ms": {k: v / per_step for k, v in class_ms.items()},
        "breakdown": {
            "device_ops": [[n[:160], s] for n, s in sorted(op_s.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n[:160], s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
        },
    }


def trace_steps(step, n: int, device: torch.device, span_names: Sequence[str],
                classes: Sequence[Tuple[str, str]]) -> dict:
    """Run ``step(i)`` for i in range(n) under the profiler and reduce it;
    ``window_s`` is the host time from the synchronise before the first step
    to the one after the last."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        sync(device)
        window_s = time.perf_counter() - t0
    out = reduce_events(kineto_events(prof), span_names, classes, n)
    out["window_s"] = window_s
    return out
