"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload s3d_gca.moco_112_b256 --seed 7 \\
        --seconds 40 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a profiler trace of a few steps after the same window).
Standard output ends with one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` with ``--trace 1``),
``checks`` last; standard error ends with one line per compared number and
its limit.  Exit codes: 0 done; 1 the run failed after it started (the line
says ``correct: false``); 2 no CUDA device, or fewer than the cell asks for;
3 JAX or the JAX package was loaded; 4 the program cannot be imported.
"""

from __future__ import annotations

import os
import sys
import time


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


T_START = time.perf_counter() - process_age_s()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:0] = [REPO]
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(REPO, ".portbench_cache", sub)

import argparse  # noqa: E402
import traceback  # noqa: E402

from portbench.core.cells import load_driver, load_reader, resolve  # noqa: E402
from portbench.core.result import emit, forbidden_modules, result_line  # noqa: E402
from portbench.reference.compare import decide  # noqa: E402


def card_info(count: int) -> dict:
    import subprocess

    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(count)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        info["power_limit"] = out[0].split(",")[-1].strip() if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "unknown"
    return info


def checks_of(numbers: dict, limits: dict) -> dict:
    return {n: {"value": v, "limit": limits.get(n, {}).get("limit"), "where": where}
            for n, (v, where) in numbers.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import video_graph_ssl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program cannot be imported: {e}", file=sys.stderr)
        return 4
    driver = load_driver(cell)
    opts = driver.Opts(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                       t_start=T_START)
    return report(cell, driver, opts, bool(args.trace), card_info)


def report(cell, driver, opts, trace: bool, card) -> int:
    """Run ``driver`` on ``cell`` and print the result; ``card(count)`` gives
    the device's entries of the line."""
    try:
        out = driver.run(cell, opts)
    except Exception:                      # the run's boundary: report, then fail
        traceback.print_exc()
        device = card(cell.chips)
        device.pop("power_limit", None)
        device["memory_peak_bytes"] = 0
        emit(result_line(False, 0, 0, {}, device, {}), {})
        return 1
    found = sorted(set(out["forbidden"]) | set(forbidden_modules()))
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    checks = checks_of(out["numbers"], cell.limits)
    correct = bool(checks) and decide(out["numbers"], {n: v["limit"] for n, v in
                                                       cell.limits.items()})
    device = card(cell.chips)
    power = device.pop("power_limit", "unknown")
    device["memory_peak_bytes"] = int(out["peak_bytes"])
    breakdown = None
    if trace:
        summary = out["summary"]
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(cell, m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = summary["breakdown"]
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out["metrics"]}
    print(f"portbench: {device['kind']}, power limit {power}; {out['steps']} steps in "
          f"{out['window_s']:.3f} s", file=sys.stderr)
    emit(result_line(correct, out["steps"], out["failed"], metrics, device, checks, breakdown,
                     {"power_limit": power}), checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
