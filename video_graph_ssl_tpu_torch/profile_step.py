"""Where the pretrain or downstream step's time goes on the card.

    python -m video_graph_ssl_tpu_torch.profile_step \\
        --config_file configs/visual_moco.yaml MODEL.AUG_FLAG True \\
        DATASET.SOURCE synthetic [CONTRAST.MEM_TYPE bank CONTRAST.NCE_K 65536] \\
        [CROSS.MODALITY cross]   # CMC: two encoder stacks, moco or bank
    python -m video_graph_ssl_tpu_torch.profile_step \\
        --config_file configs/visual_simsiam.yaml MODEL.AUG_FLAG True \\
        DATASET.SOURCE synthetic DATALOADER.BATCH_SIZE 32
    python -m video_graph_ssl_tpu_torch.profile_step \\
        --config_file configs/visual_moco.yaml MODEL.AUG_FLAG True \\
        DATASET.SOURCE synthetic MODEL.BACKBONE resnet3d_18   # any 3D ResNet
    python -m video_graph_ssl_tpu_torch.profile_step \\
        --config_file configs/visual_moco.yaml DATASET.SOURCE synthetic \\
        MODEL.BACKBONE resnet101 MODEL.BACKBONE_TYPE 2D DATALOADER.BATCH_SIZE 16 \\
        INPUT.BASE_SIZE "[224, 224]" INPUT.SCALE_SIZE "[256, 256]"   # a 2D one
    python -m video_graph_ssl_tpu_torch.profile_step --downstream finetune \\
        DATASET.SOURCE synthetic      # configs/action_fine_tune.yaml
    python -m video_graph_ssl_tpu_torch.profile_step --downstream probe \\
        DATASET.SOURCE synthetic      # configs/action_linear_probe.yaml

``--downstream`` profiles ``train_ds``'s fused step (the ``train``
augmentation, the forward, the backward and SGD) on the config given, by
default the one named above.

Builds the trainer, runs ``--warmup`` steps, times ``--steps`` steps, then
traces ``--steps`` more with ``torch.profiler`` (CPU and CUDA activities)
and prints: the step time (host clock around synchronised steps, untraced
and traced), the device-busy share (union of kernel intervals over wall
time), device time by kernel class and by phase of the step (the spans of
the regime ``CONTRAST.MEM_TYPE`` (``cmc_moco`` or ``cmc_bank`` under CMC) or
of the downstream step: ``engine/pretrain.py:REGIME_PHASES``),
for the bank (CMC's too: both memories' gathers) the device time of its
gather and logits, the top kernels and
aten ops by device time, and ``max_memory_allocated``.  Needs a CUDA
device; it never measures on the CPU.
"""

from __future__ import annotations

import argparse
import atexit
import itertools
import re
import shutil
import tempfile
import time
from collections import defaultdict

import torch

from .engine.pretrain import PHASES, REGIME_PHASES, regime_of
from .train_video_contrast_dis import Trainer, load_config
from .utils import tracing

DOWNSTREAM_CONFIGS = {"finetune": "configs/action_fine_tune.yaml",
                      "probe": "configs/action_linear_probe.yaml"}

# kernel-name pattern -> class, first match wins
CLASSES = (
    ("K1 adjacency", r"sim_partial_kernel|adjacency_epilogue_kernel"),
    ("K2 propagate", r"propagate_tc_kernel|propagate_simt_kernel"),
    ("K3/K4 max-pool backward", r"maxpool_bwd_kernel"),
    ("K5 sepconv backward", r"conv_taps_kernel|wgrad_taps_kernel|bn_sums_kernel|bn_means_kernel|"
                            r"bn_bwd_kernel|bn_bwd_vec_kernel|split_sum_kernel|"
                            r"sep_prep_kernel|sep_tc_p[1-6]_"),
    ("batch norm", r"batch_norm|batchnorm|bn_fw|bn_bw|bn_"),
    ("conv (cuDNN/cutlass)", r"conv|cudnn|xmma|implicit|dgrad|wgrad|fprop|sm90_|cutlass|nhwc"),
    ("gemm", r"gemm|cublas|matmul"),
    ("max pool", r"max_pool|maxpool|pool"),
    ("reduce", r"reduce"),
    ("copy / layout", r"copy|transpose|permute|cat|fill|index"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def classify(name: str) -> str:
    low = name.lower()
    for label, pat in CLASSES:
        if re.search(pat, low):
            return label
    return "other"


def k5_product(name: str):
    """"P1".."P6" for a kernel of K5's tensor-core route (one kernel name
    per product, ``csrc/sepconv_bwd_tc.cuh``), else None."""
    m = re.search(r"sep_tc_(p[1-6])_", name.lower())
    return m.group(1).upper() if m else None


def busy_ms(intervals) -> float:
    """Length of the union of [start, end) intervals, in ms (us inputs)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def _self_device_us(avg) -> float:
    v = getattr(avg, "self_device_time_total", None)
    return avg.self_cuda_time_total if v is None else v


def _device_us(event) -> float:
    v = getattr(event, "device_time_total", None)
    return event.cuda_time_total if v is None else v


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config_file", default="",
                    help="default: configs/visual_moco.yaml, or with --downstream "
                         "the fine-tune or linear-probe config")
    ap.add_argument("--downstream", default="", choices=["", *DOWNSTREAM_CONFIGS],
                    help="profile train_ds's step instead of the pretrain step")
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--top_ops", type=int, default=25,
                    help="aten ops (with input shapes) by self device time")
    ap.add_argument("opts", nargs="*", help="config overrides: KEY VALUE ...")
    args = ap.parse_intermixed_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")

    config_file = args.config_file or DOWNSTREAM_CONFIGS.get(args.downstream,
                                                             "configs/visual_moco.yaml")
    cfg = load_config(config_file, args.opts)
    # the trainer's saver makes an experiment directory; this tool saves nothing
    run_dir = tempfile.mkdtemp(prefix="profile_step_run_")
    atexit.register(shutil.rmtree, run_dir, True)
    if args.downstream:
        from .train_ds import Trainer as DownstreamTrainer

        trainer = DownstreamTrainer(cfg, device="cuda", run_dir=run_dir)
        to_device = trainer.batch_to_device
        lr = trainer.lr_fn(0)

        def step(batch):
            return trainer.train_step(*batch, lr)
    else:
        trainer = Trainer(cfg, device="cuda", run_dir=run_dir)
        lr = trainer.lr_fn(0)

        def to_device(b):
            return trainer.to_device(b), trainer.index_of(b)

        def step(batch):
            return trainer.train_step(batch[0], lr, batch[1])
    bsz = trainer.batch_size
    n = args.warmup + 2 * args.steps
    epoch = trainer.train_loader.epoch(0)
    batches = [to_device(b) for b in itertools.islice(epoch, n)]
    epoch.close()
    batches = (batches * n)[:n]   # an epoch may hold fewer batches than n
    for batch in batches[:args.warmup]:
        step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for batch in batches[args.warmup:args.warmup + args.steps]:
        step(batch)
    torch.cuda.synchronize()
    plain_step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    tracing.reset_counters()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        for batch in batches[args.warmup + args.steps:]:
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    step_ms = wall_ms / args.steps

    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    # the record_function spans also appear as device annotation ranges
    kernels = [e for e in device_events if e.name not in PHASES]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity; time "
                           "with CUDA events instead")
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    dev_total = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    busy = busy_ms(intervals)
    span = (max(e for _, e in intervals) - min(s for s, _ in intervals)) / 1e3
    by_name, by_class, count = defaultdict(float), defaultdict(float), defaultdict(int)
    by_product = defaultdict(float)
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] += us
        by_class[classify(e.name)] += us
        count[e.name] += 1
        if k5_product(e.name):
            by_product[k5_product(e.name)] += us

    mem_type = args.downstream or regime_of(cfg)
    phases = REGIME_PHASES["downstream" if args.downstream else mem_type]
    print(f"device: {torch.cuda.get_device_name(0)}; regime {mem_type}; batch {bsz}; "
          f"{args.steps} traced steps after {args.warmup} warm-up; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB (untraced steps)")
    print(f"step: {plain_step_ms:.1f} ms untraced ({bsz / plain_step_ms * 1e3:.1f} "
          f"clips/s), {step_ms:.1f} ms traced (host clock, {args.steps} steps each); "
          f"kernels per step: {len(kernels) / args.steps:.0f}")
    n = tracing.counters()
    calls = {"K1": n["graph_adjacency"], "K2": n["gcn_propagate"], "K3": n["maxpool_bwd_s1"],
             "K4": n["maxpool_bwd_strided"], "K5": n["sepconv_bwd"], "K5 tc": n["sepconv_bwd_tc"],
             "pool dy copies": n["maxpool_dy_copies"], "sepconv g copies": n["sepconv_g_copies"]}
    print("kernel wrapper calls per step: " + ", ".join(
        f"{k} {v / args.steps:g}" for k, v in calls.items()))
    print(f"traced: device busy {busy:.1f} ms of a {span:.1f} ms kernel span and "
          f"{wall_ms:.1f} ms wall, idle share {1 - busy / wall_ms:.3f} (tracing "
          f"slows the host); untraced estimate {1 - busy / args.steps / plain_step_ms:.3f} "
          f"(1 - busy per step / untraced step)")
    print(f"device time by class (sum over kernels, {dev_total / args.steps:.1f} ms/step):")
    for label, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {label:<24s} {us / 1e3 / args.steps:8.2f} ms/step  "
              f"{us / 1e3 / dev_total:6.1%}")
    if by_product:
        print("K5 tensor-core products: " + ", ".join(
            f"{k} {v / 1e3 / args.steps:.2f}" for k, v in sorted(by_product.items()))
            + " ms/step")
    print("device time by phase of the step (kernels launched inside each "
          "record_function span; the backward runs on the autograd thread "
          "and falls in the rest):")
    phase_ms = defaultdict(float)
    for e in prof.events():
        if e.name in PHASES and e.device_type == torch.autograd.DeviceType.CPU:
            phase_ms[e.name] += _device_us(e) / 1e3
    for name in phases:
        if name != "backward":
            print(f"  {name:<12s} {phase_ms[name] / args.steps:8.2f} ms/step")
    rest = (dev_total - sum(phase_ms.values())) / args.steps
    print(f"  {'backward and the rest':<12s} {rest:8.2f} ms/step")
    print(f"top {args.top} kernels by device time:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {us / 1e3 / args.steps:8.2f} ms/step  x{count[name] // args.steps:<4d} "
              f"{name[:110]}")
    ops = [a for a in prof.key_averages(group_by_input_shape=True)
           if a.key.startswith("aten::") and _self_device_us(a) > 0]
    if mem_type in ("bank", "cmc_bank"):
        # the gather of the (B, K+1) rows and the bmm of the logits, forward
        # and backward: ops whose input shapes hold the K+1 dimension
        kp1 = int(cfg.CONTRAST.NCE_K) + 1
        bank_ops = [a for a in ops if a.key in ("aten::index_select", "aten::bmm",
                                                "aten::index", "aten::gather")
                    and any(kp1 in s or bsz * kp1 in s for s in a.input_shapes if s)]
        total = sum(_self_device_us(a) for a in bank_ops) / 1e3 / args.steps
        print(f"bank gather + logits (K+1 = {kp1}): " + ", ".join(
            f"{a.key} x{a.count // args.steps} {_self_device_us(a) / 1e3 / args.steps:.2f}"
            for a in bank_ops) + f" ms/step; total {total:.2f} ms/step")
    print(f"top {args.top_ops} aten ops by self device time (input shapes):")
    for a in sorted(ops, key=lambda a: -_self_device_us(a))[:args.top_ops]:
        print(f"  {_self_device_us(a) / 1e3 / args.steps:8.2f} ms/step  "
              f"x{a.count // args.steps:<4d} {a.key:<36s} {str(a.input_shapes)[:120]}")


if __name__ == "__main__":
    main()
