"""Device and host time of the graph kernels (K1, K2) and the max-pool
backward (K3/K4) at the shapes of the bs-128 16x112x112 GCA step.

    python video_graph_ssl_tpu_torch/kernel_times.py [--root DIR] [--tag NAME]

Run as a file so that ``--root`` (default: the checkout holding this file)
decides which checkout's ``video_graph_ssl_tpu_torch`` is imported and
built: the same script then times an older tree's wrappers, whose call
signatures it shares (``graph_kernel.adjacency_fwd_kernel``,
``gcn_propagate._launch``, ``maxpool._launch``).  For each shape in bf16 it
prints one JSON line with three times:

* ``device_us``: the kernels' own time per call, from ``torch.profiler``
  (the sum of the device time of every kernel the call launches, over 50
  calls, divided by 50);
* ``host_us``: the wrapper's host time per call (100 calls without a
  synchronise, host clock);
* ``event_ms``: CUDA events around one call, wrapper included, the median
  of 20 (what ``chip_smoke.py`` records per launch).

Needs a CUDA device; it never measures on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

# (B, T, D) of K1's q/k and (B, T, H, W, C) of K2's input at S3D aug points
# 5, 9 and 14 of the bs-128, 16x112x112 step (chip_smoke.py's K1_SHAPES,
# K2_SHAPES)
K1_SHAPES = [(128, 8, 7 * 7 * 96), (128, 4, 3 * 3 * 256), (128, 2, 1 * 1 * 416)]
K2_SHAPES = [(128, 8, 14, 14, 192), (128, 4, 7, 7, 512), (128, 2, 3, 3, 832)]
# the step's max pools: (name, x (B, T, H, W, C), window, stride, padding)
POOLS = [("pool_1", (128, 8, 56, 56, 64), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
         ("pool_4", (128, 8, 28, 28, 192), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
         ("pool_7", (128, 8, 14, 14, 480), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
         ("pool_13", (128, 4, 7, 7, 832), (2, 2, 2), (2, 2, 2), (0, 0, 0)),
         ("mixed_3b", (128, 8, 14, 14, 192), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
         ("mixed_4b", (128, 4, 7, 7, 480), (3, 3, 3), (1, 1, 1), (1, 1, 1)),
         ("mixed_5b", (128, 2, 3, 3, 832), (3, 3, 3), (1, 1, 1), (1, 1, 1))]
PATTERNS = {"K1": r"adjacency|sim_partial", "K2": r"propagate", "K3/K4": r"maxpool_bwd"}


def device_us(fn, pattern: str, iters: int = 50) -> float:
    """Device time per call of the kernels whose names match ``pattern``."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and re.search(pattern, e.name)]
    if not kernels:
        raise RuntimeError(f"the profiler recorded no kernel matching {pattern!r}")
    return sum(e.time_range.elapsed_us() for e in kernels) / iters


def host_us(fn, iters: int = 100) -> float:
    """Host time per call, no synchronise between calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def event_ms(fn, iters: int = 20) -> float:
    """Median time of one call in ms (CUDA events, wrapper included)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def times(fn, pattern: str) -> dict:
    return {"device_us": device_us(fn, pattern), "host_us": host_us(fn),
            "event_ms": event_ms(fn)}


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=here, help="checkout whose port is timed")
    ap.add_argument("--tag", default="", help="label printed in every line")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.ops import maxpool as mp

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    src = os.path.dirname(gk.__file__)
    print(f"kernel_times {args.tag}: {gpu}; port from {src}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def emit(kernel, shape, t):
        print(json.dumps({"tag": args.tag, "kernel": kernel, "shape": list(shape),
                          "dtype": "bf16", "gpu": gpu, **t}))

    for b, t, d in K1_SHAPES:
        q = torch.randn(b, t, d, device=dev, generator=g).to(bf)
        k = torch.randn(b, t, d, device=dev, generator=g).to(bf)
        theta = torch.rand(t, t, device=dev, generator=g)
        emit("K1", (b, t, d), times(lambda: gk.adjacency_fwd_kernel(
            q, k, theta, None, 7, 1.0, True, 0), PATTERNS["K1"]))
    for shape in K2_SHAPES:
        b, t = shape[:2]
        x = torch.randn(shape, device=dev, generator=g).to(bf)
        adj = torch.rand(b, t, t, device=dev, generator=g).to(bf)
        for tr in (False, True):
            emit("K2" + (" transpose" if tr else ""), shape, times(
                lambda: gp._launch(adj, x, transpose=tr), PATTERNS["K2"]))
    cl = torch.channels_last_3d
    for name, (b, t, h, w, c), k, s, p in POOLS:
        x = torch.randn(b, c, t, h, w, device=dev, generator=g).to(bf).contiguous(
            memory_format=cl)
        y = F.max_pool3d(x, k, s, p).contiguous(memory_format=cl)
        dy = torch.randn(y.shape, device=dev, generator=g).to(bf).contiguous(memory_format=cl)
        emit(f"K3/K4 {name}", (b, t, h, w, c), times(
            lambda: mp._launch(x, y, dy, k, s, p), PATTERNS["K3/K4"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
