"""Ranks as data: a traffic with ``ranks`` 2 runs two processes through the
program's own launcher (gloo on the CPU here, NCCL on cards), each with its
rows of every global batch, and rank 0's state is checked against the
one-process reference over the global batch."""

import copy
import time

from portbench.drivers import pretrain as drv


def test_two_gloo_ranks(tiny_cell):
    cell = copy.deepcopy(tiny_cell)
    cell.traffic = {**cell.traffic, "ranks": 2}
    cell.settings = {**cell.settings, "DATALOADER.BATCH_SIZE": 4, "TPU.COMPUTE_DTYPE": "float32"}
    out = drv.run(cell, drv.Opts(seed=2 ** 31 + 3, seconds=0.5, trace=False,
                                 t_start=time.perf_counter(), device="cpu", backend="gloo"))
    assert out["steps"] >= 1 and out["forbidden"] == []
    assert out["metrics"]["clips_per_s"] > 0 and out["units_per_step"] == 4
    numbers = {k: v[0] for k, v in out["numbers"].items()}
    # one step in float32 against the float32 reference over the global batch
    assert numbers["keys_gap"] < 1e-3 and numbers["stem_var_gap"] < 1e-4
    assert numbers["grad_median_gap"] < 1e-2 and numbers["ema_delta_median_gap"] < 1e-3
