"""The run's result line, its comparison lines and the check that neither
JAX nor the JAX package was loaded."""

from __future__ import annotations

import json
import math
import sys

# top-level module names that no measured process may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "video_graph_ssl_tpu")


def forbidden_modules() -> list:
    """The top-level names of ``sys.modules`` (the part before the first dot,
    compared whole) that are in :data:`FORBIDDEN`."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _num(x):
    return x if x is None or math.isfinite(x) else str(x)


def check_lines(checks: dict) -> list:
    """One line per compared number: ``name value <= limit (where)``."""
    return [f"check {name} {_num(c['value'])} limit {_num(c['limit'])} ({c['where']})"
            for name, c in checks.items()]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown=None, extra=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out.update(extra or {})
    out["checks"] = {n: {"value": _num(c["value"]), "limit": _num(c["limit"])}
                     for n, c in checks.items()}
    return json.dumps(out)


def emit(line: str, checks: dict) -> None:
    """The comparison lines as the last lines of standard error, the result as
    the last line of standard output."""
    sys.stdout.flush()
    for text in check_lines(checks):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
