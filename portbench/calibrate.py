"""Readings that a cell's comparison limits are set from, in one process:
the program's numbers on many seeds, the control's (the reference with its
products in float8 e4m3) and a planted fault's (half of each batch left out,
the mean taken over the rest) on a few, all against the float32 reference
at the cell's own sizes.  The benchmark's runs never run this.

    python3 portbench/calibrate.py --workload s3d_gca.moco_112_b256 \\
        --seeds 11 12 13 --control 11 12 13 --fault 11 12 13 \\
        --out calibrate.jsonl --dump calibrate.pt

One JSON line per reading (``kind`` program, control or half_batch) on
standard output and in ``--out``; with ``--dump``, every reading's per-leaf
norms (both sides) and every BN's per-channel batch-variance gap in a
``torch.save`` file, to derive other numbers from.  A state or an EMA left
unchanged reads 1 in ``delta_median_gap`` or ``ema_delta_median_gap`` by the
definition of the number, and needs no run.
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:0] = [REPO]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench.core.cells import resolve  # noqa: E402
from portbench.drivers import pretrain as drv  # noqa: E402
from portbench.reference.compare import bn_var_gap, compare, diagnostics  # noqa: E402
from portbench.reference.models import make_queue  # noqa: E402
from portbench.reference.pretrain import run_moco  # noqa: E402


def reference(settings, seed, pool, steps, **kw):
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return run_moco(settings, seed, pool, steps, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        gc.collect()
        torch.cuda.empty_cache()


def dump_entry(kind: str, seed: int, readings: dict, ref: dict) -> dict:
    """Per-leaf norms of both sides and per-channel BN gaps."""
    bn = {enc: {n: bn_var_gap(readings, ref, enc, n) for n in ref["bn"][enc]}
          for enc in ("model", "ema")}
    return {"kind": kind, "seed": seed,
            "prog": {k: readings.get(k) for k in ("loss", "grad", "delta", "ema_delta")},
            "ref": {k: ref[k] for k in ("loss", "grad", "delta", "ema_delta", "ema_apart")},
            "bn_gap": bn}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", type=int, nargs="*", default=[])
    ap.add_argument("--bf16", type=int, nargs="*", default=[],
                    help="seeds of a witness: the reference with bf16 products")
    ap.add_argument("--out", default="")
    ap.add_argument("--dump", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config

    cell = resolve(args.workload)
    s = cell.settings
    n_check = int(cell.traffic["check_steps"])
    trainer = Trainer(load_config("", drv.overrides(s, args.seeds[0])), device="cuda",
                      run_dir=os.path.join(os.environ.get("TMPDIR", "/tmp"), "calibrate_run"))
    dev = trainer.device
    lr = trainer.lr_fn(trainer.start_epoch)
    b = int(s["DATALOADER.BATCH_SIZE"])
    sink = open(args.out, "a") if args.out else None
    dumped = []

    def emit(kind, seed, readings, ref, extra=None):
        numbers = compare(readings, ref, cell.config)
        line = json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                           "card": torch.cuda.get_device_name(0),
                           **{k: v[0] for k, v in numbers.items()},
                           **diagnostics(readings, ref),
                           "where": {k: v[1] for k, v in numbers.items()}, **(extra or {})})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        if args.dump:
            dumped.append(dump_entry(kind, seed, readings, ref))
            torch.save({"workload": cell.name, "entries": dumped}, args.dump)

    for seed in dict.fromkeys(args.seeds + args.control + args.fault + args.bf16):
        t0 = time.perf_counter()
        pool = drv.make_pool(seed, int(cell.traffic["pool_batches"]), drv.batch_shape(s), dev)
        ref = reference(s, seed, pool, n_check)
        t_ref = time.perf_counter() - t0
        if seed in args.seeds:
            w0, k0 = drv.reference_weights(s, seed, dev)
            drv.load_inputs(trainer.state, w0, k0,
                            make_queue(seed, int(s["CONTRAST.NCE_K"]), int(s["CROSS.FEAT_DIM"]), dev))
            w0, k0 = ({n: t.cpu() for n, t in w.items()} for w in (w0, k0))
            trainer.state.seed = seed + 2
            prog = drv.readings(trainer.state,
                                lambda k: trainer.train_step(pool[k % pool.shape[0]], lr),
                                w0, k0, s, n_check)
            del w0, k0
            gc.collect()
            torch.cuda.empty_cache()
            emit("program", seed, prog, ref,
                 {"loss": prog["loss"], "ref_loss": ref["loss"], "ref_s": t_ref})
        if seed in args.control:
            emit("control", seed, reference(s, seed, pool, n_check, rounding="fp8"), ref)
        if seed in args.bf16:
            emit("bf16_reference", seed, reference(s, seed, pool, n_check, rounding="bf16"),
                 ref)
        if seed in args.fault:
            emit("half_batch", seed, reference(s, seed, pool, n_check, keep_rows=b // 2), ref)
        del pool, ref
        gc.collect()
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
