#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. device and set-up: needs ``torch.cuda.is_available()``; prints the
   card's name and power limit, the torch and CUDA versions; builds the
   kernels from ``video_graph_ssl_tpu_torch/csrc`` with nvcc (sm_90a), one
   nvcc per source, in parallel.
2. K1 (graph adjacency) against its plain PyTorch version at the three S3D
   aug-point shapes of the bs-128 16x112x112 step, fp32 and bf16 inputs:
   unsampled, sampled with given noise, the in-kernel Philox draw, and the
   closed-form backward against autograd of the plain version; then T = 32
   at the first aug point's D, a ragged D and a D below one split, two
   calls bit-equal; kernel and plain times, and in bf16 the kernels'
   device-only time (``torch.profiler``) and the wrapper's host time per
   call (``video_graph_ssl_tpu_torch/kernel_times.py``).
3. K2 (GCN propagation) likewise: forward, transpose mode (each twice,
   bit-equal), autograd dx and dadj; T = 32, F ragged to 64 and to 8, adj
   in fp32; then kernel, plain, ``torch.bmm``, device-only and host times.
4. K3/K4 (max-pool backward) at the shape of every pool of one S3D pass,
   fp32 and bf16: against the plain version (exact), against torch's own
   max_pool3d backward (random cotangent; ones cotangent on inputs that
   tie), then kernel, plain and torch times beside each launch's shared
   memory per block and block count; then every pool geometry at ragged
   shapes (C not a multiple of 8, odd H and W, T = 1) against the plain
   version (exact); then every pool of the 16x224x224 step at bs 32
   against the plain version (exact), each with its plan (strips of dx
   rows where a slab exceeds a block), the strip plans timed.
5. K5 (SepConv pair backward) against its plain version on all seven
   outputs at five Mixed-block shapes, one small ragged shape (the simt
   route in both dtypes) and one small aligned shape (128-row tiles that
   straddle clip edges), fp32 and bf16, each with its route (bf16 with C
   and F multiples of 8 takes the tensor-core route); two calls bit-equal;
   then kernel, plain and unfused-backward times at all 18 fused SepConvs
   of a pass, each with its launch plan, and the wrapper's host time per
   call.
6. the slice: a small S3D+graph step on the card against the same step on
   the CPU; the port's trainer at full S3D width (configs/visual_moco.yaml,
   graph on, bs 128, 16x112x112, NCE_K 16384, bf16 compute) for 2 warm-up
   and 3 timed steps, with the kernels' launch counts read around exactly
   those steps; then the same with ``TPU.SEPCONV_FUSED True`` (small step
   card vs CPU, then the full-width trainer); then the default step at
   16x224x224 (``INPUT.BASE_SIZE [224, 224]``, ``SCALE_SIZE [256, 256]``)
   at bs 32, whose stem and Mixed_3b/3c pools run K3/K4 in strips.

Times are CUDA events around one call, the median of 20 calls (10 for K5;
``kernel_times.event_ms``).  ``bound``
is the least time the card could take: the larger of the bytes the
function must move over 3.35 TB/s and its operations over the peak rate
of its type (989 TFLOP/s bf16, 67 TFLOP/s fp32), for the published H100
SXM at 700 W.

The line before the last is the per-kernel JSON record: ``launches`` is
the kernel's wrapper-call count over the 5 steps of the 112x112 trainer run
that uses it, ``max_abs_err`` the largest kernel-vs-plain difference of its
checks, and ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` the
kernel's, its plain version's, its bound's and the library call's times
summed over the shapes of one encoder pass in bf16.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

import torch

# kernel timing shared with the script that times older trees; K1_SHAPES
# (B, T, D) of K1's q/k and K2_SHAPES (B, T, H, W, C) of K2's input at S3D
# aug points 5, 9 and 14 of the bs-128, 16x112x112 step
from video_graph_ssl_tpu_torch.kernel_times import (K1_SHAPES, K2_SHAPES, PATTERNS, device_us,
                                                    event_ms, host_us)

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "visual_moco.yaml")

# K1 edges: T = 32 at the first aug point's D (many splits), ragged D
# (scalar loads), D below one split
K1_EDGE = [(4, 32, 7 * 7 * 96), (5, 8, 37), (64, 8, 3)]

# Tolerances, as max|kernel - plain| / max(1, max|plain|) unless noted.
# fp32: the kernels sum in another order than cuBLAS -> ~1e-6 relative.
# bf16 outputs: one bf16 ulp (2^-8 relative) where rounding flips.
TOL = {"fp32": 1e-5, "bf16": 8e-3}
TOL_SAMPLED = 1e-4   # logit(p) amplifies p's rounding by 1/(p(1-p))
TOL_GRAD = {"fp32": 1e-4, "bf16": 1e-2}   # relative to max|grad|
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
CL = torch.channels_last_3d

# H100 SXM published peaks at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}

# (name, kernel, x (B, T, H, W, C), window, stride, padding) of every max
# pool of one S3D pass at bs 128, 16x112x112
POOLS = [("pool_1", "K4", (128, 8, 56, 56, 64), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
         ("pool_4", "K4", (128, 8, 28, 28, 192), (1, 3, 3), (1, 2, 2), (0, 1, 1)),
         ("pool_7", "K4", (128, 8, 14, 14, 480), (3, 3, 3), (2, 2, 2), (1, 1, 1)),
         ("pool_13", "K4", (128, 4, 7, 7, 832), (2, 2, 2), (2, 2, 2), (0, 0, 0))] + [
    (f"mixed_{blk} pool", "K3", shape, (3, 3, 3), (1, 1, 1), (1, 1, 1))
    for blk, shape in (("3b", (128, 8, 14, 14, 192)), ("3c", (128, 8, 14, 14, 256)),
                       ("4b", (128, 4, 7, 7, 480)), ("4c", (128, 4, 7, 7, 512)),
                       ("4d", (128, 4, 7, 7, 512)), ("4e", (128, 4, 7, 7, 512)),
                       ("4f", (128, 4, 7, 7, 528)), ("5b", (128, 2, 3, 3, 832)),
                       ("5c", (128, 2, 3, 3, 832)))]
# the same pools in the 16x224x224 step at bs 32 (activations of the size
# of the bs-128 112x112 step's): frame sizes 56, 28, 14, 7, 3 at 112x112
# are 112, 56, 28, 14, 7 at 224x224 (pool_13 rounds 7 down to 3, not 14 to 6)
HW_224 = {56: 112, 28: 56, 14: 28, 7: 14, 3: 7}
POOLS_224 = [(name, kn, (32, t, HW_224[h], HW_224[w], c), k, s, p)
             for name, kn, (_, t, h, w, c), k, s, p in POOLS]
# (name, (B, T, H, W), C, F) of the 18 fused SepConvs of one S3D pass
_MIXED = {"3b": ((128, 8, 14, 14), (96, 128), (16, 32)),
          "3c": ((128, 8, 14, 14), (128, 192), (32, 96)),
          "4b": ((128, 4, 7, 7), (96, 208), (16, 48)),
          "4c": ((128, 4, 7, 7), (112, 224), (24, 64)),
          "4d": ((128, 4, 7, 7), (128, 256), (24, 64)),
          "4e": ((128, 4, 7, 7), (144, 288), (32, 64)),
          "4f": ((128, 4, 7, 7), (160, 320), (32, 128)),
          "5b": ((128, 2, 3, 3), (160, 320), (32, 128)),
          "5c": ((128, 2, 3, 3), (192, 384), (48, 128))}
SEPCONVS = [(f"{blk} {br}", bthw, c, f) for blk, (bthw, *brs) in _MIXED.items()
            for br, (c, f) in zip(("b1", "b2"), brs)]
# K5 checks: four branch-1 shapes, one narrow branch-2 shape, a small
# ragged one (C, F not multiples of 8: the simt route in both dtypes; 64-row
# tiles straddle clip edges) and a small aligned one (the tensor-core route
# in bf16 on 128-row tiles that straddle clip edges, N below a tile)
K5_CHECKS = ["3b b1", "3c b1", "4f b1", "5c b1", "4c b2"]
K5_SMALL = ("small", (2, 4, 6, 6), 5, 7)
K5_ALIGNED = ("small aligned", (2, 4, 6, 6), 16, 24)
# two calls bit-equal (no atomics): an S3D shape and both small shapes
K5_DETERMINISM = ["4f b1", "small aligned", "small"]
# K5 tolerances, per output.  The function is discontinuous: dz = [z > 0] g
# at both ReLUs.  The kernel sums in another order than cuDNN, so a
# pre-activation within rounding of 0 can land on the other side of its
# ReLU (fp32: a few of 25M elements; bf16, whose y1/y2 rounding step is
# 2^-8: many more).  One flip moves its channel's BN sums by about
# 1/sqrt(elements per channel) relative, and through the BN mean terms every
# element of dy, dx and dW a little, so at bs 128 two fp32 summation orders
# of this function differ by far more than fp32 rounding.  Each output is
# held to a rel-L2 bound, and the small shape, where a flip is improbable,
# to the fp32 summation-order bound.
TOL_K5 = {"fp32": 1e-2, "bf16": 2e-2}
TOL_K5_SMALL = 1e-4
# torch's own pool backward: fp32 sums in another order; bf16 accumulates in
# bf16 (atomics), several bf16 steps off the kernel's fp32 sums
TOL_POOL_LIB = {"fp32": 1e-5, "bf16": 5e-2}
# ragged pool shapes (B, T, H, W, C): C 12 (bf16) or 6 (fp32) takes the
# kernel's scalar path; odd H, W; T = 1 where the window fits
POOL_RAGGED = [(2, 5, 9, 7, None), (2, 1, 9, 9, None), (3, 4, 7, 5, 40)]


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol and math.isfinite(err)
    print(f"  {name:<52s} err {err:.3e}  tol {tol:.0e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name}: error {err:.3e} above {tol:.0e}")


def bound(nbytes: float, flops: float, dn: str):
    """(ms, "bytes" or "operations"): the larger of the two floors."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[dn] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _bound_by(bys) -> str:
    return "operations" if "operations" in bys else "bytes"


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# --------------------------------------------------------------------------- #
def phase_k1(dev) -> dict:
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.ops.temporal_graph import hop_weight_matrix

    print("phase 2: K1 graph adjacency vs plain")
    worst, ms, plain_ms, bound_ms = 0.0, 0.0, 0.0, 0.0
    bys = set()
    g = torch.Generator(device=dev).manual_seed(0)
    timings = []
    for b, t, d in K1_SHAPES:
        theta = torch.from_numpy(hop_weight_matrix(t, 3, 0.5)).to(dev)
        for dn, dt in DTYPES.items():
            q = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(dt)
            k = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(dt)
            u = torch.rand(b, t, t, device=dev, generator=g) * (1 - 2e-6) + 1e-6
            tag = f"({b},{t},{d}) {dn}"
            a_k = gk.adjacency_fwd_kernel(q, k, theta, None, 0, 1.0, False, 0)
            a_p = gk._adjacency_fwd_plain(q, k, theta, None, 0, 1.0, False, 0)
            for name, x, y in zip(("adj", "S", "p"), a_k, a_p):
                check(f"K1 {tag} sample=False {name}", rel_err(x, y), TOL["fp32"])
                worst = max(worst, max_abs(x, y))
            s_k = gk.adjacency_fwd_kernel(q, k, theta, u, 0, 1.0, True, 0)[0]
            s_p = gk._adjacency_fwd_plain(q, k, theta, u, 0, 1.0, True, 0)[0]
            check(f"K1 {tag} sample=True, given u", rel_err(s_k, s_p), TOL_SAMPLED)
            worst = max(worst, max_abs(s_k, s_p))

            # in-kernel Philox: range, determinism, seed dependence
            a1 = gk.adjacency_fwd_kernel(q, k, theta, None, 1234, 1.0, True, 0)[0]
            a2 = gk.adjacency_fwd_kernel(q, k, theta, None, 1234, 1.0, True, 0)[0]
            a3 = gk.adjacency_fwd_kernel(q, k, theta, None, 1235, 1.0, True, 0)[0]
            torch.cuda.synchronize()
            if not (float(a1.min()) >= 0.0 and float(a1.max()) <= 1.0):
                raise RuntimeError("K1 Philox adj outside [0, 1]")
            if not torch.equal(a1, a2):
                raise RuntimeError("K1 Philox: same seed, different adj")
            if torch.equal(a1, a3):
                raise RuntimeError("K1 Philox: different seed, same adj")

            # closed-form backward (kernel forward) vs autograd of the plain
            gout = torch.randn(b, t, t, device=dev, generator=g)
            for sample in (False, True):
                qa, ka = q.clone().requires_grad_(), k.clone().requires_grad_()
                adj = gk.GraphAdjacencyFn.apply(gk.adjacency_fwd_kernel, qa, ka,
                                                theta, u, 0, 1.0, sample, 0)
                dq_k, dk_k = torch.autograd.grad((adj * gout).sum(), (qa, ka))
                qb, kb = q.clone().requires_grad_(), k.clone().requires_grad_()
                adj = gk.graph_adjacency_plain(qb, kb, theta, 0, 1.0, sample, u)
                dq_p, dk_p = torch.autograd.grad((adj * gout).sum(), (qb, kb))
                for name, x, y in (("dq", dq_k, dq_p), ("dk", dk_k, dk_p)):
                    err = float((x.float() - y.float()).abs().max()
                                / y.float().abs().max().clamp_min(1e-30))
                    check(f"K1 {tag} sample={sample} {name} (rel)", err, TOL_GRAD[dn])
            fwd = lambda: gk.adjacency_fwd_kernel(q, k, theta, None, 7, 1.0, True, 0)
            tk = event_ms(fwd)
            tp = event_ms(lambda: gk._adjacency_fwd_plain(
                q, k, theta, None, 7, 1.0, True, 0))
            # reads q, k, theta; writes adj, S, p (fp32); q.k^T dominates
            bm, by = bound(2 * q.numel() * q.element_size() + 4 * t * t + 3 * 4 * b * t * t,
                           2 * b * t * t * d, dn)
            dev_us = host = None
            if dn == "bf16":
                dev_us, host = device_us(fwd, PATTERNS["K1"]), host_us(fwd)
            timings.append((tag, tk, tp, bm, by, dev_us, host))
            if dn == "bf16":
                bys.add(by)
                ms += tk
                plain_ms += tp
                bound_ms += bm
    # Philox moments on 4096 x 32 x 32 draws: std of the mean ~1.4e-4
    b, t, d = 4096, 32, 8
    q = torch.randn(b, t, d, device=dev, generator=g)
    theta = torch.from_numpy(hop_weight_matrix(t, 3, 0.5)).to(dev)
    u_out = torch.empty(b, t, t, device=dev)
    a_k = gk.adjacency_fwd_kernel(q, q, theta, None, 99, 1.0, True, 0, u_out=u_out)[0]
    a_p = gk._adjacency_fwd_plain(q, q, theta, u_out, 99, 1.0, True, 0)[0]
    check("K1 (4096,32,8) fp32 Philox draw, adj vs plain on u_out",
          rel_err(a_k, a_p), TOL_SAMPLED)
    a_k = gk.adjacency_fwd_kernel(q, q, theta, None, 0, 1.0, False, 3)[0]
    a_p = gk._adjacency_fwd_plain(q, q, theta, None, 0, 1.0, False, 3)[0]
    check("K1 (4096,32,8) fp32 band mask nei_size=3", rel_err(a_k, a_p), TOL["fp32"])
    check("K1 Philox (4096,32,32) |mean(u) - 1/2|", abs(float(u_out.mean()) - 0.5), 2e-3)
    check("K1 Philox (4096,32,32) |var(u) - 1/12|", abs(float(u_out.var()) - 1 / 12), 1e-3)
    # the draw is clamped to [eps, 1 - eps] in fp32; allow one fp32 ulp
    u_min, u_max = float(u_out.min()), float(u_out.max())
    print(f"  K1 Philox u range [{u_min!r}, {u_max!r}]")
    if not (0.99e-6 <= u_min and u_max <= 1.0 - 0.99e-6):
        raise RuntimeError(f"K1 Philox u range [{u_min!r}, {u_max!r}] "
                           "outside [1e-6, 1 - 1e-6]")
    # T = 32 at a step-sized D, ragged D (scalar loads), D below one split
    for b, t, d in K1_EDGE:
        theta = torch.from_numpy(hop_weight_matrix(t, 3, 0.5)).to(dev)
        for dn, dt in DTYPES.items():
            q = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(dt)
            k = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(dt)
            plan = gk.adjacency_plan(b, t, d, dt)
            tag = f"K1 ({b},{t},{d}) {dn} [{plan.splits} splits, {plan.vec}-element loads]"
            for name, x, y in zip(("adj", "S", "p"),
                                  gk.adjacency_fwd_kernel(q, k, theta, None, 0, 1.0, False, 0),
                                  gk._adjacency_fwd_plain(q, k, theta, None, 0, 1.0, False, 0)):
                check(f"{tag} {name}", rel_err(x, y), TOL["fp32"])
                worst = max(worst, max_abs(x, y))
            first = gk.adjacency_fwd_kernel(q, k, theta, None, 5, 1.0, True, 0)
            second = gk.adjacency_fwd_kernel(q, k, theta, None, 5, 1.0, True, 0)
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                raise RuntimeError(f"{tag}: two calls with one seed differ")
    for tag, tk, tp, bm, by, dev_us, host in timings:
        print(f"  K1 {tag} sampled fwd: kernel {tk:.4f} ms  plain {tp:.4f} ms  "
              f"bound {bm:.4f} ms ({by})  library: no single call"
              + (f"  device-only {dev_us:.2f} us, wrapper host {host:.1f} us per call"
                 if dev_us is not None else ""))
    return {"name": "graph_adjacency", "route": "cuda",
            "source": "video_graph_ssl_tpu_torch/csrc/graph_adjacency.cu",
            "replaces": "video_graph_ssl_tpu/ops/pallas/graph_kernel.py:75",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": _bound_by(bys), "library_ms": None}


def phase_k2(dev) -> dict:
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp

    print("phase 3: K2 GCN propagation vs plain")
    worst, ms, plain_ms, bound_ms, lib_ms = 0.0, 0.0, 0.0, 0.0, 0.0
    bys = set()
    g = torch.Generator(device=dev).manual_seed(1)
    timings = []
    for shape in K2_SHAPES:
        b, t = shape[:2]
        for dn, dt in DTYPES.items():
            x = torch.randn(shape, device=dev, generator=g).to(dt)
            adj = torch.rand(b, t, t, device=dev, generator=g).to(dt)
            tag = f"{shape} {dn}"
            for tr in (False, True):
                y_k = gp._launch(adj, x, transpose=tr)
                y_p = gp.propagate_plain(adj, x, transpose=tr)
                check(f"K2 {tag} transpose={tr}", rel_err(y_k, y_p), TOL[dn])
                worst = max(worst, max_abs(y_k, y_p))
                if not torch.equal(y_k, gp._launch(adj, x, transpose=tr)):
                    raise RuntimeError(f"K2 {tag} transpose={tr}: two calls differ")
            gout = torch.randn(shape, device=dev, generator=g).to(dt)
            xa, aa = x.clone().requires_grad_(), adj.clone().requires_grad_()
            dx_k, da_k = torch.autograd.grad(
                (gp._GcnPropagate.apply(aa, xa).float() * gout.float()).sum(), (xa, aa))
            xb, ab = x.clone().requires_grad_(), adj.clone().requires_grad_()
            dx_p, da_p = torch.autograd.grad(
                (gp.propagate_plain(ab, xb).float() * gout.float()).sum(), (xb, ab))
            check(f"K2 {tag} dx", rel_err(dx_k, dx_p), TOL[dn])
            err = float((da_k.float() - da_p.float()).abs().max()
                        / da_p.float().abs().max())
            check(f"K2 {tag} dadj (rel)", err, TOL_GRAD[dn])
            fwd = lambda: gp._launch(adj, x, transpose=False)
            tk = event_ms(fwd)
            tp = event_ms(lambda: gp.propagate_plain(adj, x))
            tl = event_ms(lambda: torch.bmm(adj, x.view(b, t, -1)))
            # reads x and adj, writes out; 2 T FLOPs per output element
            bm, by = bound((2 * x.numel() + adj.numel()) * x.element_size(),
                           2 * t * x.numel(), dn)
            dev_us = host = None
            if dn == "bf16":
                dev_us, host = device_us(fwd, PATTERNS["K2"]), host_us(fwd)
            plan = gp.propagate_plan(b, t, x.numel() // (b * t), dt)
            timings.append((tag, tk, tp, tl, bm, by, dev_us, host, plan))
            if dn == "bf16":
                bys.add(by)
                ms += tk
                plain_ms += tp
                lib_ms += tl
                bound_ms += bm
    # edge shapes: T = 32 (T padded to 32 on the tensor cores; dynamic shared
    # memory above 48 KB), F not a multiple of 64 (a part-full last slice),
    # F not a multiple of 8 (CUDA cores), adj in fp32 (rounded in the kernel)
    for shape in ((4, 32, 4, 4, 64), (3, 32, 3, 3, 40), (2, 3, 3, 5, 7)):
        for (dn, dt), adj_dt in itertools.product(DTYPES.items(), (None, torch.float32)):
            x = torch.randn(shape, device=dev, generator=g).to(dt)
            adj = torch.rand(shape[0], shape[1], shape[1], device=dev, generator=g).to(
                adj_dt or dt)
            route = gp.propagate_plan(shape[0], shape[1], x.numel() // (shape[0] * shape[1]),
                                      dt).route
            for tr in (False, True):
                y_k = gp._launch(adj, x, transpose=tr)
                check(f"K2 {shape} {dn} adj {str(adj.dtype)[6:]} ({route}) transpose={tr}",
                      rel_err(y_k, gp.propagate_plain(adj, x, transpose=tr)), TOL[dn])
                if not torch.equal(y_k, gp._launch(adj, x, transpose=tr)):
                    raise RuntimeError(f"K2 {shape} {dn}: two calls differ")
    for tag, tk, tp, tl, bm, by, dev_us, host, plan in timings:
        print(f"  K2 {tag} fwd ({plan.route}, {plan.blocks} blocks): kernel {tk:.4f} ms  "
              f"plain {tp:.4f} ms  torch.bmm {tl:.4f} ms  bound {bm:.4f} ms ({by})"
              + (f"  device-only {dev_us:.2f} us, wrapper host {host:.1f} us per call"
                 if dev_us is not None else ""))
    return {"name": "gcn_propagate", "route": "cuda",
            "source": "video_graph_ssl_tpu_torch/csrc/gcn_propagate.cu",
            "replaces": "video_graph_ssl_tpu/ops/pallas/gcn_propagate.py:74",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": _bound_by(bys), "library_ms": lib_ms}



def _ncdhw(shape_bthwc, dev, dt, g, fill=None) -> torch.Tensor:
    """A (B, C, T, H, W) channels_last_3d tensor for a (B, T, H, W, C) shape."""
    b, t, h, w, c = shape_bthwc
    x = (torch.randn((b, c, t, h, w), device=dev, generator=g) if fill is None
         else fill((b, c, t, h, w)))
    return x.to(dt).contiguous(memory_format=CL)


def phase_pools(dev) -> list:
    from video_graph_ssl_tpu_torch.ops import maxpool as mp
    import torch.nn.functional as F

    print("phase 4: K3/K4 max-pool backward vs plain and torch")
    g = torch.Generator(device=dev).manual_seed(2)
    worst = {"K3": 0.0, "K4": 0.0}
    sums = {kn: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0) for kn in worst}
    rows = []
    for name, kn, shape, k, s, p in POOLS:
        for dn, dt in DTYPES.items():
            x = _ncdhw(shape, dev, dt, g)
            y, idx = F.max_pool3d(x, k, s, p, return_indices=True)
            y = y.contiguous(memory_format=CL)
            dy = torch.randn(y.shape, device=dev, generator=g).to(dt).contiguous(
                memory_format=CL)
            tag = f"{kn} {name} {shape} {dn}"
            dx_k = mp._launch(x, y, dy, k, s, p)
            dx_p = mp.max_pool3d_bwd_plain(x, y, dy, k, s, p)
            check(f"{tag} vs plain (max abs)", max_abs(dx_k, dx_p), 0.0)
            worst[kn] = max(worst[kn], max_abs(dx_k, dx_p))
            dx_l = torch.ops.aten.max_pool3d_with_indices_backward(
                dy, x, list(k), list(s), list(p), [1, 1, 1], False, idx)
            check(f"{tag} vs torch", rel_err(dx_k, dx_l), TOL_POOL_LIB[dn])
            if dn == "bf16":   # few levels: most windows tie
                xt = _ncdhw(shape, dev, dt, g, fill=lambda sh: torch.randint(
                    0, 4, sh, device=dev, generator=g).float())
                yt, it = F.max_pool3d(xt, k, s, p, return_indices=True)
                yt = yt.contiguous(memory_format=CL)
                ones = torch.ones_like(yt)
                tied = mp._launch(xt, yt, ones, k, s, p)
                ref = torch.ops.aten.max_pool3d_with_indices_backward(
                    ones, xt, list(k), list(s), list(p), [1, 1, 1], False, it)
                check(f"{tag} ties, ones cotangent vs torch (max abs)",
                      max_abs(tied, ref), 0.0)
            tk = event_ms(lambda: mp._launch(x, y, dy, k, s, p))
            tp = event_ms(lambda: mp.max_pool3d_bwd_plain(x, y, dy, k, s, p))
            tl = event_ms(lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                dy, x, list(k), list(s), list(p), [1, 1, 1], False, idx))
            # what the function needs: read x, y and dy, write dx
            bm, by = bound(2 * (x.numel() + y.numel()) * x.element_size(), 0, dn)
            plan = mp.bwd_plan(x.shape, k, s, p, dt)
            rows.append((tag, tk, tp, tl, bm, by, plan))
            if dn == "bf16":
                for key, v in zip(("ms", "plain_ms", "library_ms", "bound_ms"),
                                  (tk, tp, tl, bm)):
                    sums[kn][key] += v
            del x, y, idx, dy, dx_k, dx_p, dx_l
    for tag, tk, tp, tl, bm, by, plan in rows:
        print(f"  {tag}: kernel {tk:.4f} ms  plain {tp:.4f} ms  torch {tl:.4f} ms  "
              f"bound {bm:.4f} ms ({by})  [{plan.slab} slabs, {plan.group}-channel "
              f"groups, {plan.smem_bytes} B shared memory per block, {plan.blocks} "
              f"blocks of {plan.threads} threads]")
    geoms = sorted({(k, s, p) for _, _, _, k, s, p in POOLS})
    for (k, s, p), shape, (dn, dt) in itertools.product(geoms, POOL_RAGGED,
                                                         DTYPES.items()):
        shape = shape[:4] + (shape[4] or (12 if dn == "bf16" else 6),)
        if shape[1] + 2 * p[0] < k[0]:
            continue
        kn = "K3" if s == (1, 1, 1) else "K4"
        x = _ncdhw(shape, dev, dt, g)
        y = F.max_pool3d(x, k, s, p).contiguous(memory_format=CL)
        dy = torch.randn(y.shape, device=dev, generator=g).to(dt).contiguous(
            memory_format=CL)
        err = max_abs(mp._launch(x, y, dy, k, s, p), mp.max_pool3d_bwd_plain(x, y, dy, k, s, p))
        check(f"{kn} k{k} s{s} p{p} {shape} {dn} vs plain (max abs)", err, 0.0)
        worst[kn] = max(worst[kn], err)
    # every pool of the 16x224x224 step at bs 32, exact; the slabs above
    # one block's shared memory run in strips of dx rows with halos
    print("  K3/K4 at 16x224x224, bs 32 (strips where a slab exceeds a block):")
    for name, kn, shape, k, s, p in POOLS_224:
        for dn, dt in DTYPES.items():
            x = _ncdhw(shape, dev, dt, g)
            y = F.max_pool3d(x, k, s, p).contiguous(memory_format=CL)
            dy = torch.randn(y.shape, device=dev, generator=g).to(dt).contiguous(
                memory_format=CL)
            plan = mp.bwd_plan(x.shape, k, s, p, dt)
            strips = plan.t_strips * plan.h_strips
            tag = (f"{kn} {name} {shape} {dn} [{strips} strip(s) of {plan.t_strip} frames x "
                   f"{plan.h_strip} rows, {plan.blocks} blocks, {plan.smem_bytes} B]")
            err = max_abs(mp._launch(x, y, dy, k, s, p), mp.max_pool3d_bwd_plain(x, y, dy, k, s, p))
            check(f"{tag} vs plain (max abs)", err, 0.0)
            worst[kn] = max(worst[kn], err)
            if dn == "bf16" and strips > 1:
                idx = F.max_pool3d(x, k, s, p, return_indices=True)[1]
                tk = event_ms(lambda: mp._launch(x, y, dy, k, s, p))
                tl = event_ms(lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                    dy, x, list(k), list(s), list(p), [1, 1, 1], False, idx))
                bm, by = bound(2 * (x.numel() + y.numel()) * x.element_size(), 0, dn)
                print(f"  {kn} {name} {shape} bf16 in strips: kernel {tk:.4f} ms  torch "
                      f"{tl:.4f} ms  bound {bm:.4f} ms ({by})")
                del idx
            del x, y, dy
    src = "video_graph_ssl_tpu_torch/csrc/maxpool_bwd.cu"
    return [{"name": "maxpool_bwd_s1", "route": "cuda", "source": src,
             "replaces": "video_graph_ssl_tpu/ops/pallas/maxpool_kernel.py:130",
             "max_abs_err": worst["K3"], "bound_by": "bytes", **sums["K3"]},
            {"name": "maxpool_bwd_strided", "route": "cuda", "source": src,
             "replaces": "video_graph_ssl_tpu/ops/pallas/maxpool_kernel.py:259",
             "max_abs_err": worst["K4"], "bound_by": "bytes", **sums["K4"]}]


def _sep_inputs(bthwc, dev, dt, g):
    """x, the pair's parameters, its forward statistics and a cotangent:
    the argument tuple of sepconv_bwd / bwd_reference."""
    from video_graph_ssl_tpu_torch.ops import fused_sepconv as fs

    b, t, h, w, c, f = bthwc
    x = _ncdhw((b, t, h, w, c), dev, dt, g)
    ws = torch.randn(f, c, 1, 3, 3, device=dev, generator=g) / (9 * c) ** 0.5
    wt = torch.randn(f, f, 3, 1, 1, device=dev, generator=g) / (3 * f) ** 0.5
    bn = [1 + 0.1 * torch.randn(f, device=dev, generator=g) if i % 2 == 0
          else 0.1 * torch.randn(f, device=dev, generator=g) for i in range(4)]
    out, stats = fs.sepconv_fwd_core(x, ws, wt, *bn, dt)
    gy = torch.randn(out.shape, device=dev, generator=g).to(dt).contiguous(
        memory_format=CL)
    return (x, ws, wt, *bn, *stats, gy, dt)


def _sep_bound(bthwc, dn):
    """Six conv-sized products (y1, y2, da, dx, dWt, dWs) against reading x
    and g and writing dx."""
    b, t, h, w, c, f = bthwc
    rows = b * t * h * w
    flops = 3 * 2 * rows * 9 * c * f + 3 * 2 * rows * 3 * f * f
    isz = 2 if dn == "bf16" else 4
    nbytes = rows * (2 * c + f) * isz + (9 * c * f + 3 * f * f) * (isz + 4)
    return bound(nbytes, flops, dn)


def _sep_plan_str(p) -> str:
    """One line of a K5 launch plan (ops/sepconv_bwd.py:plan)."""
    if p.route == "simt":
        return "simt, 64x64x16 fp32 tiles"
    p1, p5 = p.product("P1 y1"), p.product("P5 dx")
    wg = ", ".join(f"{q.name.split()[1]} {q.tile[0]}x{q.tile[1]}x{q.shared_taps} taps, "
                   f"{q.splits} splits" for q in (p.product("P4 dWt"), p.product("P6 dWs")))
    return (f"tc, conv 128x{p1.tile[1]} (F) / 128x{p5.tile[1]} (C), "
            f"{p1.smem_bytes}/{p5.smem_bytes} B smem, {p.mtiles} row tiles; {wg}")


def _unfused_bwd(args, dev):
    """The pair's backward through the path the default step runs: autograd
    of SepConv3d(fused_bwd=False) (cuDNN conv + BN) with the same weights,
    input and cotangent; returns a function that runs it once."""
    from video_graph_ssl_tpu_torch.models.layers import SepConv3d

    x, ws, wt, g1, b1, g2, b2, _, _, _, _, gy, dt = args
    f, c = ws.shape[:2]
    m = SepConv3d(c, f, 3, 1, 1, dtype=dt).to(dev).train()
    with torch.no_grad():
        for prm, v in zip((m.conv_s.weight, m.conv_t.weight, m.bn_s.weight, m.bn_s.bias,
                           m.bn_t.weight, m.bn_t.bias), (ws, wt, g1, b1, g2, b2)):
            prm.copy_(v)
    xr = x.detach().requires_grad_()
    out = m(xr)
    leaves = [xr, *m.parameters()]
    return lambda: torch.autograd.grad(out, leaves, gy, retain_graph=True)


def phase_k5(dev) -> dict:
    from video_graph_ssl_tpu_torch.ops import fused_sepconv as fs
    from video_graph_ssl_tpu_torch.ops import sepconv_bwd as sb

    print("phase 5: K5 SepConv pair backward vs plain (cudnn.allow_tf32 False)")
    g = torch.Generator(device=dev).manual_seed(3)
    names = ["dx", "dWs", "dWt", "dg1", "db1", "dg2", "db2"]
    by_name = {n: (bthw, c, f) for n, bthw, c, f in SEPCONVS + [K5_SMALL, K5_ALIGNED]}
    worst = 0.0
    for name in K5_CHECKS + [K5_SMALL[0], K5_ALIGNED[0]]:
        bthw, c, f = by_name[name]
        for dn, dt in DTYPES.items():
            args = _sep_inputs((*bthw, c, f), dev, dt, g)
            route = sb.plan(*bthw, c, f, dt).route
            got = sb.sepconv_bwd(*args)
            want = fs.bwd_reference(*args)
            for n, a, r in zip(names, got, want):
                tag = f"K5 {name} {bthw} {c}->{f} {dn} ({route}) {n}"
                worst = max(worst, max_abs(a, r))
                mx = float((a.float() - r.float()).abs().max()
                           / r.float().abs().max().clamp_min(1e-30))
                print(f"  {tag}: max rel {mx:.3e}")
                check(f"{tag} (rel-L2)", rel_l2(a, r), TOL_K5[dn])
                if name == K5_SMALL[0] and dn == "fp32":
                    check(f"{tag} (max rel)", mx, TOL_K5_SMALL)
            del args, got, want
    for name in K5_DETERMINISM:
        bthw, c, f = by_name[name]
        for dn, dt in DTYPES.items():
            args = _sep_inputs((*bthw, c, f), dev, dt, g)
            first, second = sb.sepconv_bwd(*args), sb.sepconv_bwd(*args)
            same = all(torch.equal(a, b) for a, b in zip(first, second))
            route = sb.plan(*bthw, c, f, dt).route
            print(f"  K5 {name} {dn} ({route}): two calls bit-equal: {same}")
            if not same:
                raise RuntimeError(f"K5 {name} {dn}: two calls differ")
            del args, first, second
    rows, sums, bys = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, unfused_ms=0.0), set()
    for name, bthw, c, f in SEPCONVS:
        args = _sep_inputs((*bthw, c, f), dev, torch.bfloat16, g)
        unfused = _unfused_bwd(args, dev)
        tk = event_ms(lambda: sb.sepconv_bwd(*args), iters=10)
        tp = event_ms(lambda: fs.bwd_reference(*args), iters=10)
        tu = event_ms(unfused, iters=10)
        bm, by = _sep_bound((*bthw, c, f), "bf16")
        rows.append((name, bthw, c, f, tk, tp, tu, bm, by,
                     _sep_plan_str(sb.plan(*bthw, c, f, torch.bfloat16))))
        for key, v in zip(("ms", "plain_ms", "unfused_ms", "bound_ms"), (tk, tp, tu, bm)):
            sums[key] += v
        bys.add(by)
        del args, unfused
    for name, bthw, c, f, tk, tp, tu, bm, by, plan in rows:
        print(f"  K5 {name} {bthw} {c}->{f} bf16: kernel {tk:.4f} ms  plain {tp:.3f} ms  "
              f"unfused {tu:.4f} ms  bound {bm:.4f} ms ({by})  library: no single call  "
              f"[{plan}]")
    print(f"  K5 all 18 SepConvs of a pass, bf16: kernel {sums['ms']:.3f} ms  "
          f"plain {sums['plain_ms']:.2f} ms  unfused {sums['unfused_ms']:.3f} ms  "
          f"bound {sums['bound_ms']:.3f} ms")
    # the wrapper's host time: 100 calls at 5b b2 without a sync
    name, bthw, c, f = next(r for r in SEPCONVS if r[0] == "5b b2")
    args = _sep_inputs((*bthw, c, f), dev, torch.bfloat16, g)
    for _ in range(3):
        sb.sepconv_bwd(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        sb.sepconv_bwd(*args)
    host_us = (time.perf_counter() - t0) * 1e4
    torch.cuda.synchronize()
    print(f"  K5 wrapper host time per call at {name} {bthw} {c}->{f} bf16: {host_us:.1f} us "
          "(100 calls, no sync)")
    del args
    sums.pop("unfused_ms")
    return {"name": "sepconv_bwd", "route": "cuda",
            "source": "video_graph_ssl_tpu_torch/csrc/sepconv_bwd.cu",
            "replaces": "video_graph_ssl_tpu/ops/pallas/sepconv_bwd.py:307 and "
                        "video_graph_ssl_tpu/ops/pallas/sepconv_bwd_grid.py:314",
            "max_abs_err": worst, "bound_by": _bound_by(bys), "library_ms": None,
            **sums}

# --------------------------------------------------------------------------- #
def small_step_parity(dev, fused: bool) -> None:
    """One MoCo step of a small S3D+graph model (graph blocks at 5, 9, 14;
    fp32; sampler none; TPU.SEPCONV_FUSED as given) from one initial state
    and one batch: the card (kernels) against the CPU (plain versions)."""
    from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
    from video_graph_ssl_tpu_torch.engine.pretrain import make_moco_step
    from video_graph_ssl_tpu_torch.models.build import create_visual_model
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    print(f"  small S3D+graph MoCo step (4x16x64x64, fp32, SEPCONV_FUSED {fused}), "
          "card vs CPU")
    c = load_config(CONFIG, [
        "MODEL.AUG_FLAG", "True", "GRAPH.SAMPLER", "none",
        "TPU.COMPUTE_DTYPE", "float32", "CONTRAST.NCE_K", "64",
        "CONTRAST.NCE_T", "1.0", "TPU.SEPCONV_FUSED", str(fused)])
    clips = torch.randn(4, 2, 16, 64, 64, 3,
                        generator=torch.Generator().manual_seed(3))
    runs = {}
    for name, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
        model, _ = create_visual_model(c)
        state = create_pretrain_state(c, model, d)
        p0 = [p.detach().cpu().double() for p in state.model.parameters()]
        step = make_moco_step(float(c.CONTRAST.NCE_T), float(c.CONTRAST.ALPHA))
        loss = float(step(state, clips.to(d), 0.06)["loss"])
        delta = torch.cat([(p.detach().cpu().double() - q).flatten()
                           for p, q in zip(state.model.parameters(), p0)])
        runs[name] = (loss, state.contrast.queue.cpu(), delta)
    (lc, qc, dc), (lg, qg, dg) = runs["cpu"], runs["gpu"]
    tag = f"slice small (fused {fused})"
    check(f"{tag}: loss", abs(lc - lg) / max(1.0, abs(lc)), 1e-4)
    # Train-mode BN over 4 clips amplifies rounding in the deep stages: the
    # keys of fp32 and fp64 runs on the CPU already differ by 8e-5.
    check(f"{tag}: queue (keys of the EMA pass)", rel_err(qg, qc), 1e-3)
    # At init the features of all clips nearly coincide, so the gradient
    # through the L2 normalisation cancels: fp32 against fp64 on the CPU
    # already differs by 3e-2 (rel-L2 of the whole update).
    check(f"{tag}: parameter update (rel-L2)",
          float((dg - dc).norm() / dc.norm()), 1e-1)


def _counters():
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.ops import maxpool as mp
    from video_graph_ssl_tpu_torch.ops import sepconv_bwd as sb
    return gk, gp, mp, sb


def reset_counts() -> None:
    gk, gp, mp, sb = _counters()
    gk.launches = gp.launches = mp.launches_s1 = mp.launches_strided = 0
    sb.launches = sb.launches_tc = mp.dy_copies = sb.g_copies = 0


def read_counts() -> dict:
    gk, gp, mp, sb = _counters()
    return {"graph_adjacency": gk.launches, "gcn_propagate": gp.launches,
            "maxpool_bwd_s1": mp.launches_s1, "maxpool_bwd_strided": mp.launches_strided,
            "sepconv_bwd": sb.launches}


def run_trainer(dev, gpu: str, fused: bool, bsz: int = 128, size: int = 112) -> dict:
    """5 trainer steps at full S3D width (2 warm-up, 3 timed), bs ``bsz``,
    16 x size x size (224: INPUT.BASE_SIZE [224, 224], SCALE_SIZE [256,
    256]); returns the launch counts of exactly those steps."""
    from video_graph_ssl_tpu_torch.data.synthetic import iterate_batches
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config

    _, _, mp, sb = _counters()
    print(f"  trainer at full S3D width, bs {bsz}, 16x{size}x{size}, SEPCONV_FUSED {fused}")
    geometry = [] if size == 112 else ["INPUT.BASE_SIZE", f"[{size}, {size}]",
                                       "INPUT.SCALE_SIZE", f"[{size * 8 // 7}, {size * 8 // 7}]"]
    c = load_config(CONFIG, ["MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "synthetic",
                             "DATALOADER.BATCH_SIZE", str(bsz),
                             "TPU.SEPCONV_FUSED", str(fused)] + geometry)
    if list(c.INPUT.BASE_SIZE) != [size, size]:
        raise RuntimeError(f"INPUT.BASE_SIZE {c.INPUT.BASE_SIZE}, want {size}")
    if int(c.CONTRAST.NCE_K) != 16384 or c.TPU.COMPUTE_DTYPE != "bfloat16":
        raise RuntimeError("configs/visual_moco.yaml no longer gives NCE_K 16384 "
                           "with bf16 compute")
    trainer = Trainer(c, max_steps=5, device="cuda")
    t0 = time.perf_counter()
    batches = [trainer.to_device(bt) for bt, _ in
               zip(iterate_batches(trainer.dataset, bsz, 0, 1), range(5))]
    print(f"  5 synthetic batches made in {time.perf_counter() - t0:.1f} s")
    lr = trainer.lr_fn(0)
    state = trainer.state
    # record the shapes the kernels see, to hold them to the tables above
    seen_pools, seen_seps = set(), set()
    pool_launch, sep_launch = mp._launch, sb.sepconv_bwd

    def pool_rec(x, y, dy, k, s, p):
        b, cc, t, h, w = x.shape
        seen_pools.add(((b, t, h, w, cc), tuple(k), tuple(s), tuple(p)))
        return pool_launch(x, y, dy, k, s, p)

    def sep_rec(x, ws, *rest):
        b, cc, t, h, w = x.shape
        seen_seps.add(((b, t, h, w), cc, ws.shape[0]))
        return sep_launch(x, ws, *rest)

    mp._launch, sb.sepconv_bwd = pool_rec, sep_rec
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        step_ms, losses, ptrs = [], [], []
        for clips in batches:
            ptr0 = state.contrast.ptr
            t0 = time.perf_counter()
            metrics = trainer.train_step(clips, lr)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            ptrs.append((ptr0, state.contrast.ptr))
        counts = read_counts()
        copies = (mp.dy_copies, sb.g_copies)
        tc_calls = sb.launches_tc
    finally:
        mp._launch, sb.sepconv_bwd = pool_launch, sep_launch
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (ms, loss) in enumerate(zip(step_ms, losses)):
        print(f"  step {i} ({'warm-up' if i < 2 else 'timed'}): {ms:.1f} ms, loss {loss:.4f}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    K = int(c.CONTRAST.NCE_K)
    for p0, p1 in ptrs:
        if p1 != (p0 + bsz) % K:
            raise RuntimeError(f"queue pointer {p0} -> {p1}, want +{bsz}")
    diff = max(float((e - p).detach().abs().max()) for e, p in zip(
        state.ema_model.parameters(), state.model.parameters()))
    if not diff > 0.0:
        raise RuntimeError("EMA params equal the params after 5 steps")
    print(f"  EMA vs params max |diff| {diff:.3e}; queue ptr {state.contrast.ptr}")
    n = len(batches)
    # K3/K4/K5 run in the query pass's backward only (the key pass takes no
    # gradient)
    want = {"graph_adjacency": 6 * n, "gcn_propagate": 9 * n, "maxpool_bwd_s1": 9 * n,
            "maxpool_bwd_strided": 4 * n, "sepconv_bwd": 18 * n if fused else 0}
    print(f"  kernel calls in the 5 steps: {counts} (want {want})")
    print(f"  cotangents copied to channels_last_3d in the 5 steps: pool dy "
          f"{copies[0]}, SepConv g {copies[1]}")
    print(f"  K5 calls on the tensor-core route: {tc_calls} (want {want['sepconv_bwd']})")
    if counts != want:
        raise RuntimeError(f"kernel call counts {counts} != {want}")
    if tc_calls != want["sepconv_bwd"] or copies[1] != 0:
        raise RuntimeError(f"K5: {tc_calls} tensor-core calls of {want['sepconv_bwd']}, "
                           f"{copies[1]} cotangent copies (want 0)")
    want_pools = {((bsz, *shape[1:]), k, s, p)
                  for _, _, shape, k, s, p in (POOLS if size == 112 else POOLS_224)}
    if seen_pools != want_pools:
        raise RuntimeError(f"pool shapes {sorted(seen_pools)} != {sorted(want_pools)}")
    want_seps = {(bthw, c_, f) for _, bthw, c_, f in SEPCONVS} if fused else set()
    if seen_seps != want_seps:
        raise RuntimeError(f"SepConv shapes {sorted(seen_seps)} != {sorted(want_seps)}")
    timed = step_ms[2:]
    mean_ms = sum(timed) / len(timed)
    print(f"slice (SEPCONV_FUSED {fused}, 16x{size}x{size}): {mean_ms:.1f} ms/step, "
          f"{bsz / mean_ms * 1e3:.1f} clips/s (mean of 3 timed steps, bs {bsz}, "
          f"peak {peak:.1f} GiB) on {gpu}")
    del trainer, state, batches, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_slice(dev, gpu: str) -> dict:
    """The default GCA step, then the TPU.SEPCONV_FUSED step, then the
    default step at 16x224x224; each kernel's count comes from the 112x112
    run of the path that uses it."""
    print("phase 6a: the GCA step")
    small_step_parity(dev, fused=False)
    counts = run_trainer(dev, gpu, fused=False)
    print("phase 6b: the GCA step with TPU.SEPCONV_FUSED True")
    small_step_parity(dev, fused=True)
    fused_counts = run_trainer(dev, gpu, fused=True)
    counts["sepconv_bwd"] = fused_counts["sepconv_bwd"]
    print("phase 6c: the GCA step at 16x224x224, bs 32 (K3/K4 in strips)")
    big = run_trainer(dev, gpu, fused=False, bsz=32, size=224)
    if not all(big[n] > 0 for n in ("graph_adjacency", "gcn_propagate", "maxpool_bwd_s1",
                                    "maxpool_bwd_strided")):
        raise RuntimeError(f"224x224 step: a kernel was not launched: {big}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from video_graph_ssl_tpu_torch.ops import _build

    gpu = gpu_line()
    print(gpu)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.last_build_seconds:.1f} s) -> {_build.library_path().name}")

    kernels = [phase_k1(dev), phase_k2(dev), *phase_pools(dev), phase_k5(dev)]
    counts = phase_slice(dev, gpu)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
