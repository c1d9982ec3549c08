"""The metric arithmetic against hand counts: the interval union, the p90
over all steps, the rate over the whole window, the reduction of a trace,
the max-pool backward's bytes without y, and the FLOP count of a tiny
model."""

import math
from types import SimpleNamespace

import pytest
import torch
from torch import nn

from portbench.core import stats
from portbench.core.trace import reduce_events
from portbench.metrics import _peaks, _rooflines, _shapes
from portbench.metrics._classes import CLASSES, K1, K34
from portbench.core.cells import resolve


def test_union_of_intervals():
    assert stats.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 10)]) == 4.0
    assert stats.union_length([]) == 0.0


def test_p90_counts_every_step():
    steps = [100.0] * 9 + [200.0]
    # linear interpolation between the 9th and 10th of 10 values
    assert stats.percentile(steps, 90) == pytest.approx(110.0)
    assert stats.percentile(list(range(1, 102)), 90) == pytest.approx(91.0)
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_intervals_and_rate_over_the_whole_window():
    marks = [0.0, 300.0, 610.0, 900.0]
    assert stats.intervals_from_marks(marks) == [300.0, 310.0, 290.0]
    # 3 steps of 256 clips in 0.9 s, not the mean of per-step rates
    assert stats.rate(3 * 256, 0.9) == pytest.approx(853.333, rel=1e-4)


def _event(name, start, dur, device, corr, linked=0):
    dev = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
                           device_type=lambda: dev, correlation_id=lambda: corr,
                           linked_correlation_id=lambda: linked)


def test_trace_attributes_device_time_to_the_span_open_at_launch():
    us = 1000
    events = [
        _event("augment", 0, 100 * us, False, 1),
        _event("aten::einsum", 10 * us, 5 * us, False, 2),
        _event("backward", 200 * us, 300 * us, False, 3),
        # launched on the autograd thread while the main thread waits in backward
        _event("aten::convolution_backward", 250 * us, 10 * us, False, 4),
        _event("gemm_kernel", 20 * us, 50 * us, True, 0, 2),
        _event("maxpool_bwd_kernel<bf16>", 400 * us, 40 * us, True, 0, 4),
        _event("sim_partial_kernel", 450 * us, 10 * us, True, 0, 4),
        _event("backward", 390 * us, 80 * us, True, 0),          # an annotation range
    ]
    out = reduce_events(events, ("augment", "backward"), CLASSES, steps=2)
    assert out["span_ms"] == {"augment": pytest.approx(0.025), "backward": pytest.approx(0.025)}
    assert out["class_ms"][K34] == pytest.approx(0.020)
    assert out["class_ms"][K1] == pytest.approx(0.005)
    assert out["busy_s"] == pytest.approx(100e-6)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["backward/aten::convolution_backward"] == pytest.approx(330e-6 + 10e-6)


def test_maxpool_bytes_leave_out_y():
    cell = resolve("s3d_gca.moco_112_b256")
    pools = _shapes.pass_shapes(cell.settings)["pools"]
    assert len(pools) == 13
    (x, y) = pools[0]                     # the stem pool: (1,3,3)/(1,2,2) at 56x56
    assert x == (256, 64, 8, 56, 56) and y == (256, 64, 8, 28, 28)
    by_hand = sum((2 * math.prod(x) + math.prod(y)) * 2 for x, y in pools)
    assert _rooflines.maxpool_bwd_bound_s(cell.settings, 1) == pytest.approx(
        by_hand / _peaks.HBM_BYTES_PER_S)


def test_graph_bytes_and_operations_by_hand():
    cell = resolve("s3d_gca.moco_112_b256")
    graphs = _shapes.pass_shapes(cell.settings)["graphs"]
    assert [g[1] for g in graphs] == [(256, 8, 14, 14, 192), (256, 4, 7, 7, 512),
                                      (256, 2, 3, 3, 832)]
    (b, t, d), x = graphs[0]
    assert d == 7 * 7 * 96
    k1 = max((2 * b * t * d * 2 + 3 * b * t * t * 4) / 3.35e12, 2 * b * t * t * d / 989e12)
    k2 = max((b * t * t * 2 + 2 * math.prod(x) * 2) / 3.35e12,
             2 * b * t * t * 14 * 14 * 192 / 989e12)
    one = _rooflines.graph_bound_s({**cell.settings, "GRAPH.AUG_POINTS": [5]}, 2, 1)
    assert one == pytest.approx(2 * k1 + 3 * k2)


def test_flop_counter_matches_a_hand_count():
    from torch.utils.flop_counter import FlopCounterMode

    net = nn.Sequential(nn.Conv3d(3, 8, (1, 3, 3), padding=(0, 1, 1), bias=False),
                        nn.Flatten(), nn.Linear(8 * 4 * 6 * 6, 5))
    x = torch.randn(2, 3, 4, 6, 6)
    counter = FlopCounterMode(display=False)
    with counter:
        net(x).sum().backward()
    conv_fwd = 2 * (2 * 8 * 4 * 6 * 6) * (3 * 9)
    lin_fwd = 2 * 2 * (8 * 4 * 6 * 6) * 5
    # backward: the linear's dx and dw, the conv's dw (its input needs no gradient)
    assert counter.get_total_flops() == conv_fwd + lin_fwd + 2 * lin_fwd + conv_fwd


def test_readers_on_a_summary():
    from portbench.core.cells import load_reader

    cell = resolve("s3d_gca.moco_112_b256")
    bound_ms = _rooflines.maxpool_bwd_bound_s(cell.settings, 1) * 1e3
    summary = {"span_ms": {"augment": 50.0, "key_pass": 40.0, "query_pass": 60.0,
                           "backward": 150.0, "optimizer": 3.0, "enqueue_ema": 1.0},
               "class_ms": {K34: 2 * bound_ms, K1: 0.0}, "busy_s": 0.9, "window_s": 1.2,
               "steps": 10, "settings": cell.settings, "ranks": 1, "regime": "moco",
               "passes": {"forward": 2, "backward": 1},
               "untraced": {"steps": 30, "window_s": 3.0}}
    read = {m["name"]: load_reader(cell, m["name"])(summary) for m in cell.per_layer}
    assert read["augment_ms"] == 50.0 and read["encoder_fwd_ms"] == 100.0
    assert read["backward_ms"] == 150.0 and read["update_ms"] == 4.0
    # 0.09 busy s a step over 30 untraced steps in 3 s, not the traced window's 25%
    assert read["device_idle_share"] == pytest.approx(10.0)
    assert read["maxpool_bwd_roofline"] == pytest.approx(50.0)
    assert read["graph_kernels_roofline"] is None        # no K1/K2 time: nothing to read
    assert 0 < read["step_mfu"] < 100
