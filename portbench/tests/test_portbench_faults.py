"""Runs of the harness (its look for a chip skipped) with the timed path
broken underneath: each fault a training cell can have on one card (a state
left unchanged, an EMA left unchanged, half of the batch left out) makes
``correct`` false, a sound run keeps it true, and a run that aborts still
prints the result line with ``correct: false``."""

import copy
import importlib.util
import json
import time

import pytest
import torch

from portbench.core.cells import ROOT, load_driver
from portbench.drivers import pretrain as drv

from test_portbench_step import CPU_LIMITS, _check64


def _report_module():
    spec = importlib.util.spec_from_file_location("portbench_run_script", ROOT / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(cell, capsys, wrap=None):
    run = _report_module()
    driver = load_driver(cell)
    opts = driver.Opts(seed=2 ** 31 + 5, seconds=0.2, trace=False, t_start=time.perf_counter(),
                       device="cpu", wrap_step=wrap)
    rc = run.report(cell, driver, opts, False,
                    lambda n: {"platform": "cpu", "kind": "cpu", "count": n})
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.fixture
def cell(tiny_cell, monkeypatch):
    monkeypatch.setattr(drv, "check", _check64)
    c = copy.deepcopy(tiny_cell)
    c.limits = CPU_LIMITS
    return c


def test_a_sound_run_is_correct(cell, capsys):
    rc, line, err = _run(cell, capsys)
    assert rc == 0 and line["correct"] is True
    assert list(line)[-1] == "checks" and set(line["checks"]) == set(CPU_LIMITS)
    assert err.strip().splitlines()[-1].startswith("check bn_var_median_gap")


def _unchanged(trainer):
    """A step that returns the state as it found it."""
    def step(raw, lr):
        state = trainer.state
        keep = [t.detach().clone() for t in list(state.model.state_dict().values())
                + list(state.ema_model.state_dict().values())]
        queue, ptr = state.contrast.queue.clone(), state.contrast.ptr
        metrics = trainer.train_step(raw, lr)
        with torch.no_grad():
            for t, k in zip(list(state.model.state_dict().values())
                            + list(state.ema_model.state_dict().values()), keep):
                t.copy_(k)
        state.contrast.queue.copy_(queue)
        state.contrast.ptr = ptr
        state.optimizer.state.clear()
        return metrics
    return step


def _ema_unchanged(trainer):
    """A step that leaves the EMA encoder's weights as it found them."""
    def step(raw, lr):
        ema = trainer.state.ema_model
        keep = [p.detach().clone() for p in ema.parameters()]
        metrics = trainer.train_step(raw, lr)
        with torch.no_grad():
            for p, k in zip(ema.parameters(), keep):
                p.copy_(k)
        return metrics
    return step


def _half_batch(trainer):
    """Half of each batch left out: the mean is taken over the rest."""
    return lambda raw, lr: trainer.train_step(raw[: raw.shape[0] // 2], lr)


@pytest.mark.parametrize("fault", [_unchanged, _ema_unchanged, _half_batch])
def test_a_fault_makes_the_run_incorrect(cell, capsys, fault):
    cell.traffic = {**cell.traffic, "check_steps": 2}
    cell.settings = {**cell.settings, "DATALOADER.BATCH_SIZE": 4}
    rc, line, _ = _run(cell, capsys, fault)
    assert rc == 0 and line["correct"] is False


def test_an_aborted_run_prints_the_line(cell, capsys):
    def broken(trainer):
        calls = []

        def step(raw, lr):
            calls.append(1)
            if len(calls) > 1:
                raise RuntimeError("planted failure inside the run")
            return trainer.train_step(raw, lr)
        return step

    rc, line, err = _run(cell, capsys, broken)
    assert rc == 1 and line["correct"] is False
    assert {"attempted", "failed", "metrics", "device"} <= set(line)
    assert "planted failure" in err
