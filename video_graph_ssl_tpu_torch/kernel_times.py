"""Device and host time of the graph kernels (K1, K2), the max-pool
forward and backward (K3/K4) and the SepConv pair backward (K5) at the
shapes of the bs-128 16x112x112 GCA step (K5: of the ``TPU.SEPCONV_FUSED
True`` step), or with ``--size 224 --batch 32`` at those of the 16x224x224
step; with
``--backbone I3D`` (or S3DG, InceptionI3d) at that backbone's shapes (I3D:
TF "SAME" pools, a 4x4 stage 14; no K5 for either); with ``--backbone
resnet3d_18`` (any 3D ResNet: ``resnet3d_*``, ``resnet_i3d_*``,
``resnet2p1d_*``) K1/K2 at its graph blocks on stages 2, 3, 4 and K4 at its
stem pool; with ``--backbone i3d_res50_nonlocal`` K1/K2 at its blocks (T = 2
at all three) and K4 at its stem pool and its temporal pool; a 2D backbone
(``resnet18`` .. ``resnet152``, ``bninception``, ``inception_v3``) runs none
of the kernels, and its lines say so.

    python video_graph_ssl_tpu_torch/kernel_times.py [--root DIR] [--tag NAME] \
        [--mem_type moco|simsiam|bank|finetune|probe|eval] [--cmc] [--size 112|224] [--batch B] \
        [--backbone S3D|S3DG|I3D|InceptionI3d|resnet3d_18|i3d_res50_nonlocal|resnet101|...]

Run as a file so that ``--root`` (default: the checkout holding this file)
decides which checkout's ``video_graph_ssl_tpu_torch`` is imported and
built: the same script then times an older tree's wrappers, whose call
signatures it shares (``graph_kernel.adjacency_fwd_kernel``,
``gcn_propagate._launch``, ``maxpool._launch``, ``sepconv_bwd.sepconv_bwd``).
For each shape in bf16 it prints one JSON line with three times:

* ``device_us``: the kernels' own time per call, from ``torch.profiler``
  (the sum of the device time of every kernel the call launches, over 50
  calls, divided by 50);
* ``host_us``: the wrapper's host time per call (100 calls without a
  synchronise, host clock);
* ``event_ms``: CUDA events around one call, wrapper included, the median
  of 20 (what ``chip_smoke.py`` records per launch).

The pool forward's lines (``pool fwd``) add ``library_device_us``, the
device time of the library's ``F.max_pool3d`` (with its indices) at the
same pool, and ``bound_us``, x read once and y written once at 3.35 TB/s.
Then one line per kernel of K3, K4, K5 and the pool forward with
``pass_device_ms``: the sum of ``device_us`` over the calls of one encoder
pass (13 pools, 18 SepConv pairs); and one line per kernel with its
wrapper calls and device ms per step of the regime ``--mem_type`` (``CONTRAST.MEM_TYPE``, or a downstream
step; default moco), as :func:`step_calls` counts them: a MoCo step runs
two encoder passes (key and query) and one backward, a SimSiam step two
passes and two backwards (one per view), a bank step one of each; a
fine-tune step one of each, a linear-probe step and an eval forward one
pass and no backward (the probe's encoder takes no gradient).  With
``--cmc`` (``CROSS.MODALITY cross``, moco or bank) every pass and backward
runs through CMC's two stacks at the same shapes (``model_2`` on the
temporal differences), so each count and each per-step time doubles.  K5's line
counts the ``TPU.SEPCONV_FUSED True`` step with ``MODEL.NO_PARTIALBN
True``: under partial BN no pair runs K5.

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
K2_SHAPES = [(128, 8, 14, 14, 192), (128, 4, 7, 7, 512), (128, 2, 3, 3, 832)]


def k1_shape(k2_shape):
    """K1's q/k (B, T, D) at a graph block whose input K2 sees as (B, T, H,
    W, C): the embeddings halve C and the (1, 2, 2) pool halves H and W."""
    b, t, h, w, c = k2_shape
    return (b, t, (h // 2) * (w // 2) * (c // 2))


K1_SHAPES = [k1_shape(s) for s in K2_SHAPES]
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
# 16x224x224: frame sizes 56, 28, 14, 7, 3 at 112x112 are 112, 56, 28, 14, 7
# (pool_13 rounds 7 down to 3, not 14 to 6)
HW_224 = {56: 112, 28: 56, 14: 28, 7: 14, 3: 7, 1: 3}


def same_pads(shape, k, s):
    """TF "SAME" (lo, hi) pads of a pool over x (B, T, H, W, C)
    (``ops/maxpool.py:same_padding``, JAX ``lax.padtype_to_pads``)."""
    pads = []
    for n, ki, si in zip(shape[1:4], k, s):
        total = max((-(-n // si) - 1) * si + ki - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


# I3D at bs 128, 16x112x112 (models/i3d.py): K2's input at aug points 5, 9
# and 14 (stage 13's "SAME" pool leaves 4x4 where S3D's leaves 3x3), and
# every max pool of one pass with its TF "SAME" (lo, hi) pads: the strided
# pools pad one more on the high side, the Mixed pools (1, 1)
I3D_K2_SHAPES = [(128, 8, 14, 14, 192), (128, 4, 7, 7, 512), (128, 2, 4, 4, 832)]
I3D_POOLS = [(n, kn, shape, k, s_, same_pads(shape, k, s_)) for n, kn, shape, k, s_ in (
    [("pool_1", "K4", (128, 8, 56, 56, 64), (1, 3, 3), (1, 2, 2)),
     ("pool_4", "K4", (128, 8, 28, 28, 192), (1, 3, 3), (1, 2, 2)),
     ("pool_7", "K4", (128, 8, 14, 14, 480), (3, 3, 3), (2, 2, 2)),
     ("pool_13", "K4", (128, 4, 7, 7, 832), (2, 2, 2), (2, 2, 2))]
    + [(n, kn, shape[:2] + (4, 4) + shape[4:] if n.startswith("mixed_5") else shape, k, s_)
       for n, kn, shape, k, s_, _ in POOLS[4:]])]
# I3D frame sizes at 224x224 (stage 13 keeps 7x7 there)
I3D_HW_224 = {56: 112, 28: 56, 14: 28, 7: 14, 4: 7}
# the 3D ResNets (models/resnet3d.py, resnet2p1d.py) and the 2D backbones
# (models/resnet2d.py, bninception.py, inceptionv3.py) by registry name
RESNET_DEPTHS = (10, 18, 34, 50, 101, 152, 200)
RESNETS_3D = tuple([f"resnet3d_{d}" for d in RESNET_DEPTHS]
                   + [f"resnet_i3d_{d}" for d in (18, 50, 101)]
                   + [f"resnet2p1d_{d}" for d in RESNET_DEPTHS])
BACKBONES_2D = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "bninception",
                "inception_v3")
# graph blocks per encoder pass, and each kernel's calls per backward pass
AUG_POINTS, POOLS_S1, POOLS_STRIDED = 3, 9, 4
# the same per backbone: S3DG and I3D have S3D's (blocks at 5, 9, 14; 9
# stride-1 and 4 strided pools); tiny3d (the graph-benefit A/B's) has one
# graph block (aug point 1) and one strided pool, (1, 2, 2) after stage1;
# a 3D ResNet has blocks on the inputs of stages 2, 3 and 4 and one strided
# pool, its stem's 3x3x3 / 2; i3d_res50_nonlocal the same blocks and two
# strided pools, the stem's and the temporal one after layer1; a 2D
# backbone runs none of the kernels (its pools are the library's, and it
# builds no graph block)
I3DNON = "i3d_res50_nonlocal"
BACKBONE_CALLS = {**{name: (AUG_POINTS, POOLS_S1, POOLS_STRIDED)
                     for name in ("S3D", "S3DG", "I3D", "InceptionI3d")},
                  "tiny3d": (1, 0, 1),
                  **{name: (3, 0, 1) for name in RESNETS_3D},
                  I3DNON: (3, 0, 2),
                  **{name: (0, 0, 0) for name in BACKBONES_2D}}
I3D_NAMES = ("I3D", "InceptionI3d")


def resnet_geometry(size: int, batch: int, backbone: str):
    """(K2_SHAPES, POOLS) of a 3D ResNet's step at 16 x size x size: the
    7x7x7 / (1, 2, 2) stem (R(2+1)D's (1,7,7) / (1,2,2) + (7,1,1) pair gives
    the same extents) leaves (16, size/2, size/2, 64), the 3x3x3 / 2 stem
    pool (padding 1) halves T, H and W, stages 2-4 halve them again; the
    graph blocks see the inputs of stages 2, 3 and 4, whose channels are
    64, 128 and 256 times the blocks' expansion (4 from depth 50)."""
    exp = 4 if int(backbone.rsplit("_", 1)[1]) >= 50 else 1
    hw = size // 4
    k2 = [(batch, 8 >> i, hw >> i, hw >> i, (64 << i) * exp) for i in range(3)]
    pools = [("stem pool", "K4", (batch, 16, size // 2, size // 2, 64), (3, 3, 3), (2, 2, 2),
              (1, 1, 1))]
    return k2, pools


def i3dnon_geometry(size: int, batch: int):
    """(K2_SHAPES, POOLS) of ``i3d_res50_nonlocal``'s step at 16 x size x
    size: the (5, 7, 7) / 2 stem leaves (8, size/2, size/2, 64), the 3x3x3 /
    2 stem pool (padding 1) (4, size/4, size/4), layer1 256 channels, whose
    temporal pool (3, 1, 1) / (2, 1, 1), pads (1, 0, 0), halves T to 2;
    stages 2-4 stride H and W only, so the graph blocks see T = 2 at size/4,
    size/8 and size/16 with 256, 512 and 1024 channels."""
    q = size // 4
    k2 = [(batch, 2, q >> i, q >> i, 256 << i) for i in range(3)]
    pools = [("stem pool", "K4", (batch, 8, size // 2, size // 2, 64), (3, 3, 3), (2, 2, 2),
              (1, 1, 1)),
             ("layer1 pool", "K4", (batch, 4, q, q, 256), (3, 1, 1), (2, 1, 1), (1, 0, 0))]
    return k2, pools
# (encoder passes, passes with a backward) of each regime's step, and of the
# downstream steps (engine/downstream.py)
REGIME_PASSES = {"moco": (2, 1), "simsiam": (2, 2), "bank": (1, 1),
                 "finetune": (1, 1), "probe": (1, 0), "eval": (1, 0)}


def gpu_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    return out.splitlines()[0]


def step_calls(mem_type: str, fused: bool = False, partial_bn: bool = False,
               graph: bool = True, backbone: str = "S3D", cmc: bool = False) -> dict:
    """Wrapper calls per step of K1-K5 and the pool forward in the regime
    ``mem_type`` (S3D, S3DG, I3D or InceptionI3d, graph blocks at 5, 9, 14
    with ``graph``, ``MODEL.AUG_FLAG``; tiny3d, one block at 1, one strided pool; a 3D
    ResNet, blocks at 2, 3, 4, one strided pool; i3d_res50_nonlocal, the
    same blocks and two strided pools; a 2D backbone, none): K1 and
    K2 once per block and pass, K2 again (transposed) in each backward,
    the pool forward (``maxpool_fwd``) once per pool and pass, K3/K4 in
    each backward, K5 (with ``TPU.SEPCONV_FUSED``, S3D only) in
    each backward unless ``partial_bn`` freezes the pairs' BNs, which takes
    them off K5.  ``cmc``: CMC's step (moco or bank), whose passes and
    backward run through two encoder stacks, each with its own graph blocks
    and pools: every count doubles."""
    if cmc and mem_type not in ("moco", "bank"):
        raise ValueError(f"CMC runs moco or bank, not {mem_type}")
    passes, grads = REGIME_PASSES[mem_type]
    stacks = 2 if cmc else 1
    passes, grads = passes * stacks, grads * stacks
    aug_points, pools_s1, pools_strided = BACKBONE_CALLS[backbone]
    blocks = aug_points if graph else 0
    sepconvs = len(SEPCONVS) if backbone == "S3D" else 0
    return {"graph_adjacency": blocks * passes,
            "gcn_propagate": blocks * (passes + grads),
            "maxpool_bwd_s1": pools_s1 * grads, "maxpool_bwd_strided": pools_strided * grads,
            "sepconv_bwd": sepconvs * grads if fused and not partial_bn else 0,
            "maxpool_fwd": (pools_s1 + pools_strided) * passes}


def geometry(size: int = 112, batch: int = 128, backbone: str = "S3D"):
    """(K1_SHAPES, K2_SHAPES, POOLS, SEPCONVS) of ``backbone``'s step at 16
    x size x size (112 or 224) and batch ``batch``: S3D's and S3DG's
    shapes, or I3D's with each pool's TF "SAME" pads for its input, or a 3D
    ResNet's (:func:`resnet_geometry`), or i3d_res50_nonlocal's
    (:func:`i3dnon_geometry`); none for a 2D backbone; K5's
    SepConvs for S3D alone (S3DG's biased pairs and the other backbones'
    convs take the standard backward).  CMC's two stacks each see these
    shapes (``model_2``'s temporal differences keep the clips' shape), so a
    CMC step runs each of them twice as often (:func:`step_calls`)."""
    if size not in (112, 224):
        raise ValueError(f"size {size}: 112 or 224")
    if backbone in BACKBONES_2D:
        return [], [], [], []
    if backbone in RESNETS_3D or backbone == I3DNON:
        k2, pools = (i3dnon_geometry(size, batch) if backbone == I3DNON
                     else resnet_geometry(size, batch, backbone))
        return [k1_shape(s_) for s_ in k2], k2, pools, []
    i3d = backbone in I3D_NAMES
    scale = I3D_HW_224 if i3d else HW_224
    hw = (lambda v: v) if size == 112 else scale.__getitem__
    k2 = [(batch, t, hw(h), hw(w), c) for _, t, h, w, c in (I3D_K2_SHAPES if i3d else K2_SHAPES)]
    pools = []
    for n, kn, (_, t, h, w, c), k, s_, p in (I3D_POOLS if i3d else POOLS):
        shape = (batch, t, hw(h), hw(w), c)
        pools.append((n, kn, shape, k, s_, same_pads(shape, k, s_) if i3d else p))
    seps = [(n, (batch, t, hw(h), hw(w)), c, f) for n, (_, t, h, w), c, f in SEPCONVS
            ] if backbone == "S3D" else []
    return [k1_shape(s_) for s_ in k2], k2, pools, seps


def pool_output(x, k, s, p):
    """The pool's y for x (B, C, T, H, W): ``F.max_pool3d`` for PyTorch
    padding, the port's forward (``maxpool.pool_forward``) for (lo, hi)
    pairs."""
    import torch.nn.functional as F
    if all(isinstance(v, int) for v in p):
        return F.max_pool3d(x, k, s, p)
    from video_graph_ssl_tpu_torch.ops import maxpool
    return maxpool.pool_forward(x, k, s, p)


PATTERNS = {"K1": r"adjacency|sim_partial", "K2": r"propagate", "K3/K4": r"maxpool_bwd",
            "pool fwd": r"maxpool_fwd_kernel", "library pool fwd": r"max_pool3d_with_indices",
            "K5": r"conv_taps_kernel|wgrad_taps_kernel|bn_sums_kernel|bn_means_kernel|"
                  r"bn_bwd_kernel|bn_bwd_vec_kernel|split_sum_kernel|sep_prep_kernel|"
                  r"sep_tc_p[1-6]_"}


def device_us(fn, pattern: str, iters: int = 50, sessions: int = 3) -> float:
    """Device time per call of the kernels whose names match ``pattern``.

    ``torch.profiler`` at times records no device event in a session, above
    all in a process that has run a process group; such a session is
    repeated, up to ``sessions`` in all.  If none records a matching kernel,
    the time is :func:`event_ms`'s (CUDA events, wrapper included) and a
    line says so."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(sessions):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and re.search(pattern, e.name)]
        if kernels:
            return sum(e.time_range.elapsed_us() for e in kernels) / iters
    print(f"  device_us: the profiler recorded no kernel matching {pattern!r} in {sessions} "
          f"sessions; CUDA events (wrapper included) give this time instead")
    return event_ms(fn, iters) * 1e3


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


def sepconv_inputs(bthwc, dev, dt, g):
    """x, the SepConv pair's parameters, its forward statistics and a
    cotangent: the argument tuple of ``sepconv_bwd`` / ``bwd_reference``."""
    import torch
    from video_graph_ssl_tpu_torch.ops import fused_sepconv as fs

    cl = torch.channels_last_3d
    b, t, h, w, c, f = bthwc
    x = torch.randn(b, c, t, h, w, device=dev, generator=g).to(dt).contiguous(memory_format=cl)
    ws = torch.randn(f, c, 1, 3, 3, device=dev, generator=g) / (9 * c) ** 0.5
    wt = torch.randn(f, f, 3, 1, 1, device=dev, generator=g) / (3 * f) ** 0.5
    bn = [1 + 0.1 * torch.randn(f, device=dev, generator=g) if i % 2 == 0
          else 0.1 * torch.randn(f, device=dev, generator=g) for i in range(4)]
    out, stats = fs.sepconv_fwd_core(x, ws, wt, *bn, dt)
    gy = torch.randn(out.shape, device=dev, generator=g).to(dt).contiguous(memory_format=cl)
    return (x, ws, wt, *bn, *stats, gy, dt)


def times(fn, pattern: str) -> dict:
    return {"device_us": device_us(fn, pattern), "host_us": host_us(fn),
            "event_ms": event_ms(fn)}


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=here, help="checkout whose port is timed")
    ap.add_argument("--tag", default="", help="label printed in every line")
    ap.add_argument("--mem_type", default="moco", choices=sorted(REGIME_PASSES),
                    help="CONTRAST.MEM_TYPE whose per-step calls are counted")
    ap.add_argument("--cmc", action="store_true",
                    help="count CMC's step (CROSS.MODALITY cross): two encoder stacks")
    ap.add_argument("--size", default=112, type=int, help="frame size: 112 or 224")
    ap.add_argument("--batch", default=128, type=int, help="batch size")
    ap.add_argument("--backbone", default="S3D",
                    choices=["S3D", "S3DG", *I3D_NAMES, *RESNETS_3D, I3DNON, *BACKBONES_2D],
                    help="MODEL.BACKBONE whose shapes are timed (a 2D one has none)")
    args = ap.parse_args(argv)
    k1_shapes, k2_shapes, pools, sepconvs = geometry(args.size, args.batch, args.backbone)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.ops import maxpool as mp
    from video_graph_ssl_tpu_torch.ops import sepconv_bwd as sb

    gpu = gpu_line()
    src = os.path.dirname(gk.__file__)
    print(f"kernel_times {args.tag}: {gpu}; port from {src}; {args.backbone}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    tag = args.tag

    def emit(kernel, shape, t):
        print(json.dumps({"tag": tag, "kernel": kernel, "shape": list(shape),
                          "dtype": "bf16", "gpu": gpu, **t}))

    pass_us = {"K1": 0.0, "K2": 0.0, "K2 transpose": 0.0, "K3": 0.0, "K4": 0.0, "K5": 0.0,
               "pool fwd": 0.0}
    for b, t, d in k1_shapes:
        q = torch.randn(b, t, d, device=dev, generator=g).to(bf)
        k = torch.randn(b, t, d, device=dev, generator=g).to(bf)
        theta = torch.rand(t, t, device=dev, generator=g)
        t_ = times(lambda: gk.adjacency_fwd_kernel(q, k, theta, None, 7, 1.0, True, 0),
                   PATTERNS["K1"])
        pass_us["K1"] += t_["device_us"]
        emit("K1", (b, t, d), t_)
    for shape in k2_shapes:
        b, t = shape[:2]
        x = torch.randn(shape, device=dev, generator=g).to(bf)
        adj = torch.rand(b, t, t, device=dev, generator=g).to(bf)
        for tr in (False, True):
            kn = "K2" + (" transpose" if tr else "")
            t_ = times(lambda: gp._launch(adj, x, transpose=tr), PATTERNS["K2"])
            pass_us[kn] += t_["device_us"]
            emit(kn, shape, t_)
    cl = torch.channels_last_3d
    for name, kn, (b, t, h, w, c), k, s, p in pools:
        x = torch.randn(b, c, t, h, w, device=dev, generator=g).to(bf).contiguous(
            memory_format=cl)
        y = pool_output(x, k, s, p).contiguous(memory_format=cl)
        dy = torch.randn(y.shape, device=dev, generator=g).to(bf).contiguous(memory_format=cl)
        t_ = times(lambda: mp._launch(x, y, dy, k, s, p), PATTERNS["K3/K4"])
        pass_us[kn] += t_["device_us"]
        emit(f"{kn} {name}", (b, t, h, w, c), t_)
        # the operator the forward calls, so host_us holds its dispatch
        flat = [v for pair in mp.resolve_padding(p, (t, h, w), k, s) for v in pair]
        t_ = times(lambda: mp.max_pool3d_fwd_op(x, k, s, flat), PATTERNS["pool fwd"])
        t_["library_device_us"] = device_us(lambda: pool_output(x, k, s, p),
                                            PATTERNS["library pool fwd"])
        # x read once, y written once, at 3.35 TB/s
        t_["bound_us"] = (x.numel() + y.numel()) * x.element_size() / 3.35e6
        pass_us["pool fwd"] += t_["device_us"]
        emit(f"pool fwd {name}", (b, t, h, w, c), t_)
    for name, (b, t, h, w), c, f in sepconvs:
        sep = sepconv_inputs((b, t, h, w, c, f), dev, bf, g)
        t_ = times(lambda: sb.sepconv_bwd(*sep), PATTERNS["K5"])
        pass_us["K5"] += t_["device_us"]
        emit(f"K5 {name}", (b, t, h, w, c, f), t_)
        del sep
    for kn in ("K3", "K4", "K5", "pool fwd"):
        calls = (len(sepconvs) if kn == "K5" else len(pools) if kn == "pool fwd"
                 else sum(r[1] == kn for r in pools))
        print(json.dumps({"tag": tag, "kernel": kn, "calls_per_pass": calls,
                          "pass_device_ms": pass_us[kn] / 1e3, "dtype": "bf16", "gpu": gpu}))
    # per step of the regime: K1 and K2 per encoder pass, K2 transposed and
    # K3-K5 per backward (K5 only with TPU.SEPCONV_FUSED True)
    stacks = 2 if args.cmc else 1
    passes, grads = (n * stacks for n in REGIME_PASSES[args.mem_type])
    calls = step_calls(args.mem_type, fused=True, backbone=args.backbone, cmc=args.cmc)
    per_step = {"K1": (calls["graph_adjacency"], pass_us["K1"] * passes),
                "K2": (calls["gcn_propagate"],
                       pass_us["K2"] * passes + pass_us["K2 transpose"] * grads),
                "K3": (calls["maxpool_bwd_s1"], pass_us["K3"] * grads),
                "K4": (calls["maxpool_bwd_strided"], pass_us["K4"] * grads),
                "K5 (SEPCONV_FUSED)": (calls["sepconv_bwd"], pass_us["K5"] * grads),
                "pool fwd": (calls["maxpool_fwd"], pass_us["pool fwd"] * passes)}
    for kn, (n, us) in per_step.items():
        print(json.dumps({"tag": tag, "kernel": kn, "mem_type": args.mem_type,
                          "cmc": args.cmc,
                          "geometry": f"{args.backbone}, bs {args.batch}, "
                                      f"16x{args.size}x{args.size}",
                          "calls_per_step": n, "step_device_ms": us / 1e3,
                          "dtype": "bf16", "gpu": gpu}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
