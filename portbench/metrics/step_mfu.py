"""The whole step's percent of one card's bf16 peak over the untraced window
that precedes the trace: model operations per step on one card's rows (the
plain reference's, counted on the ``meta`` device) x steps / window seconds /
989 TFLOP/s."""

from ._flops import moco_step_flops
from ._peaks import BF16_FLOPS_PER_S


def read(summary):
    run = summary.get("untraced")
    if not run or summary.get("regime") != "moco" or run["window_s"] <= 0:
        return None
    flops = moco_step_flops(summary["settings"], summary["ranks"])
    return 100.0 * flops * run["steps"] / run["window_s"] / BF16_FLOPS_PER_S
