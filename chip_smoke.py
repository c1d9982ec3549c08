#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. device and set-up: needs ``torch.cuda.is_available()``; prints the
   card's name and power limit, the torch and CUDA versions; builds the
   kernels from ``video_graph_ssl_tpu_torch/csrc`` with nvcc (sm_90a).
2. K1 (graph adjacency) against its plain PyTorch version at the three S3D
   aug-point shapes of the bs-128 16x112x112 step, fp32 and bf16 inputs:
   unsampled, sampled with given noise, the in-kernel Philox draw, and the
   closed-form backward against autograd of the plain version.
3. K2 (GCN propagation) likewise: forward, transpose mode, autograd dx and
   dadj; then kernel and plain times (CUDA events, median of 20).
4. the slice: one small S3D+graph step on the card against the same step on
   the CPU (plain versions), then the port's trainer at full S3D width
   (configs/visual_moco.yaml, graph on, bs 128, 16x112x112, NCE_K 16384,
   bf16 compute) for 2 warm-up and 3 timed steps, with the kernels' launch
   counts read around exactly those steps.

The line before the last is the per-kernel JSON record: ``launches`` is
the kernel's launch count over the 5 trainer steps, ``max_abs_err`` the
largest kernel-vs-plain difference of its forward checks, ``ms`` and
``plain_ms`` the kernel's and its plain version's forward times summed over
the three aug-point shapes in bf16.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "visual_moco.yaml")

# (B, T, D) of K1's q/k and (B, T, H, W, C) of K2's input at S3D aug points
# 5, 9 and 14 of the bs-128, 16x112x112 step.
K1_SHAPES = [(128, 8, 7 * 7 * 96), (128, 4, 3 * 3 * 256), (128, 2, 1 * 1 * 416)]
K2_SHAPES = [(128, 8, 14, 14, 192), (128, 4, 7, 7, 512), (128, 2, 3, 3, 832)]

# Tolerances, as max|kernel - plain| / max(1, max|plain|) unless noted.
# fp32: the kernels sum in another order than cuBLAS -> ~1e-6 relative.
# bf16 outputs: one bf16 ulp (2^-8 relative) where rounding flips.
TOL = {"fp32": 1e-5, "bf16": 8e-3}
TOL_SAMPLED = 1e-4   # logit(p) amplifies p's rounding by 1/(p(1-p))
TOL_GRAD = {"fp32": 1e-4, "bf16": 1e-2}   # relative to max|grad|
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


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


def cuda_ms(fn, iters: int = 20) -> float:
    """Median time of ``fn`` in ms over ``iters`` launches (CUDA events)."""
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


# --------------------------------------------------------------------------- #
def phase_k1(dev) -> dict:
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.ops.temporal_graph import hop_weight_matrix

    print("phase 2: K1 graph adjacency vs plain")
    worst, ms, plain_ms = 0.0, 0.0, 0.0
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
            tk = cuda_ms(lambda: gk.adjacency_fwd_kernel(
                q, k, theta, None, 7, 1.0, True, 0))
            tp = cuda_ms(lambda: gk._adjacency_fwd_plain(
                q, k, theta, None, 7, 1.0, True, 0))
            timings.append((tag, tk, tp))
            if dn == "bf16":
                ms += tk
                plain_ms += tp
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
    for tag, tk, tp in timings:
        print(f"  K1 {tag} sampled fwd: kernel {tk:.4f} ms  plain {tp:.4f} ms")
    return {"name": "graph_adjacency", "route": "cuda",
            "source": "video_graph_ssl_tpu_torch/csrc/graph_adjacency.cu",
            "replaces": "video_graph_ssl_tpu/ops/pallas/graph_kernel.py:75",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_k2(dev) -> dict:
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp

    print("phase 3: K2 GCN propagation vs plain")
    worst, ms, plain_ms = 0.0, 0.0, 0.0
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
            tk = cuda_ms(lambda: gp._launch(adj, x, transpose=False))
            tp = cuda_ms(lambda: gp.propagate_plain(adj, x))
            timings.append((tag, tk, tp))
            if dn == "bf16":
                ms += tk
                plain_ms += tp
    # edge shapes: T = 32 (dynamic shared memory above 48 KB), and an F that
    # is not a multiple of the 16-byte vector (scalar path)
    for shape in ((4, 32, 4, 4, 64), (2, 3, 3, 5, 7)):
        for dn, dt in DTYPES.items():
            x = torch.randn(shape, device=dev, generator=g).to(dt)
            adj = torch.rand(shape[0], shape[1], shape[1], device=dev, generator=g).to(dt)
            for tr in (False, True):
                check(f"K2 {shape} {dn} transpose={tr}",
                      rel_err(gp._launch(adj, x, transpose=tr),
                              gp.propagate_plain(adj, x, transpose=tr)), TOL[dn])
    for tag, tk, tp in timings:
        print(f"  K2 {tag} fwd: kernel {tk:.4f} ms  plain {tp:.4f} ms")
    return {"name": "gcn_propagate", "route": "cuda",
            "source": "video_graph_ssl_tpu_torch/csrc/gcn_propagate.cu",
            "replaces": "video_graph_ssl_tpu/ops/pallas/gcn_propagate.py:74",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


# --------------------------------------------------------------------------- #
def small_step_parity(dev) -> None:
    """One MoCo step of a small S3D+graph model (graph blocks at 5, 9, 14;
    fp32; sampler none) from one initial state and one batch: the card
    (kernels) against the CPU (plain versions)."""
    from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
    from video_graph_ssl_tpu_torch.engine.pretrain import make_moco_step
    from video_graph_ssl_tpu_torch.models.build import create_visual_model
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    print("phase 4a: small S3D+graph MoCo step (4x16x64x64, fp32), card vs CPU")
    c = load_config(CONFIG, [
        "MODEL.AUG_FLAG", "True", "GRAPH.SAMPLER", "none",
        "TPU.COMPUTE_DTYPE", "float32", "CONTRAST.NCE_K", "64",
        "CONTRAST.NCE_T", "1.0"])
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
    check("slice small: loss", abs(lc - lg) / max(1.0, abs(lc)), 1e-4)
    # Train-mode BN over 4 clips amplifies rounding in the deep stages: the
    # keys of fp32 and fp64 runs on the CPU already differ by 8e-5.
    check("slice small: queue (keys of the EMA pass)", rel_err(qg, qc), 1e-3)
    # At init the features of all clips nearly coincide, so the gradient
    # through the L2 normalisation cancels: fp32 against fp64 on the CPU
    # already differs by 3e-2 (rel-L2 of the whole update).
    check("slice small: parameter update (rel-L2)",
          float((dg - dc).norm() / dc.norm()), 1e-1)


def phase_slice(dev, gpu: str) -> dict:
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.data.synthetic import iterate_batches
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config

    small_step_parity(dev)

    print("phase 4b: trainer at full S3D width, bs 128, 16x112x112")
    c = load_config(CONFIG, ["MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "synthetic",
                             "DATALOADER.BATCH_SIZE", "128"])
    if int(c.CONTRAST.NCE_K) != 16384 or c.TPU.COMPUTE_DTYPE != "bfloat16":
        raise RuntimeError("configs/visual_moco.yaml no longer gives NCE_K 16384 "
                           "with bf16 compute")
    trainer = Trainer(c, max_steps=5, device="cuda")
    t0 = time.perf_counter()
    batches = [trainer.to_device(bt) for bt, _ in
               zip(iterate_batches(trainer.dataset, 128, 0, 1), range(5))]
    print(f"  5 synthetic batches made in {time.perf_counter() - t0:.1f} s")
    lr = trainer.lr_fn(0)
    state = trainer.state
    bsz = 128
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.launches = gp.launches = 0
    step_ms, losses, ptrs = [], [], []
    for clips in batches:
        ptr0 = state.contrast.ptr
        t0 = time.perf_counter()
        metrics = trainer.train_step(clips, lr)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        ptrs.append((ptr0, state.contrast.ptr))
    counts = {"graph_adjacency": gk.launches, "gcn_propagate": gp.launches}
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
    want = {"graph_adjacency": 6 * n, "gcn_propagate": 9 * n}
    print(f"  kernel launches in the 5 steps: {counts} (want {want})")
    if counts != want:
        raise RuntimeError(f"launch counts {counts} != {want}")
    timed = step_ms[2:]
    mean_ms = sum(timed) / len(timed)
    print(f"slice: {mean_ms:.1f} ms/step, {bsz / mean_ms * 1e3:.1f} clips/s "
          f"(mean of 3 timed steps, bs {bsz}, peak {peak:.1f} GiB) on {gpu}")
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

    kernels = [phase_k1(dev), phase_k2(dev)]
    counts = phase_slice(dev, gpu)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
