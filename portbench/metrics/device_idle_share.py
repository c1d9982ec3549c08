"""Percent of the untraced window in which no operation ran on the card:
100 (1 - device busy seconds per traced step x untraced steps / untraced
window).  The busy time per step is the union of device intervals in the
trace; the window is the one that precedes it, untouched by the profiler's
own host work."""


def read(summary):
    run = summary.get("untraced")
    if not run or run["window_s"] <= 0 or summary["steps"] <= 0 or summary["busy_s"] <= 0:
        return None
    busy_per_step = summary["busy_s"] / summary["steps"]
    return 100.0 * (1.0 - busy_per_step * run["steps"] / run["window_s"])
