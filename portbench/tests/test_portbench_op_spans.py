"""The op-level spans' reduction (``core/op_spans.py``): own time against
total time on synthetic events, the backward through ``sequence_nr``, every
device operation attributed once; the same on a real CPU profile; the phase
reduction (``core/trace.py``) untouched by the program's spans; and, on the
card, every hand-written kernel of a traced S3D step under its own span."""

import re
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd.profiler import record_function

from portbench.core.cells import resolve
from portbench.core.op_spans import attribute, reduce_op_spans
from portbench.core.trace import reduce_events
from portbench.metrics._classes import CLASSES, K1, K2, K34

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _event(name, start, dur, corr=0, thread=1, seq=-1, fwd_thread=0, device=False,
           linked=0, annotation=False):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: CUDA if device else CPU, correlation_id=lambda: corr,
        linked_correlation_id=lambda: linked, start_thread_id=lambda: thread,
        sequence_nr=lambda: seq, fwd_thread_id=lambda: fwd_thread,
        is_user_annotation=lambda: annotation)


def _kernel(name, start, dur, linked, corr=0):
    return _event(name, start, dur, corr=corr, device=True, linked=linked)


def _synthetic():
    """One step: the forward on thread 1 (the stem holding a batch norm, then
    a pool), the backward on thread 2 (the pool's backward node, whose span
    holds an op and a launch straight from Python, then the batch norm's and
    the stem conv's backward nodes), and an op outside every span."""
    us = 1000
    return [
        _event("query_pass", 0, 100 * us, corr=1),
        _event("vgs.stem", 10 * us, 40 * us, corr=2),
        _event("aten::convolution", 12 * us, 5 * us, corr=3, seq=7),
        _event("vgs.batch_norm", 20 * us, 20 * us, corr=4),
        _event("aten::native_batch_norm", 22 * us, 5 * us, corr=5, seq=8),
        # an autograd.Function's node starts before the span inside its forward
        _event("_MaxPool3d", 59 * us, 12 * us, corr=17, seq=9),
        _event("vgs.maxpool_fwd", 60 * us, 10 * us, corr=6),
        _event("aten::max_pool3d", 61 * us, 5 * us, corr=7),
        _event("aten::add", 80 * us, 1 * us, corr=8, seq=10),
        _event("backward", 200 * us, 300 * us, corr=9),
        _event("autograd::engine::evaluate_function: MaxPool3dBackward", 210 * us, 30 * us,
               corr=10, thread=2, seq=9, fwd_thread=1),
        _event("vgs.maxpool_bwd", 212 * us, 20 * us, corr=11, thread=2),
        _event("aten::empty_like", 214 * us, 2 * us, corr=12, thread=2),
        # the kernel's launch inside the span; its host op, the node, began before
        _event("cudaLaunchKernel", 220 * us, 2 * us, corr=901, thread=2, linked=10),
        _event("autograd::engine::evaluate_function: NativeBatchNormBackward0", 250 * us,
               20 * us, corr=13, thread=2, seq=8, fwd_thread=1),
        _event("aten::native_batch_norm_backward", 252 * us, 5 * us, corr=14, thread=2),
        _event("autograd::engine::evaluate_function: ConvolutionBackward0", 280 * us,
               20 * us, corr=15, thread=2, seq=7, fwd_thread=1),
        _event("aten::convolution_backward", 282 * us, 5 * us, corr=16, thread=2),
        # device work, and two annotation ranges that are not work
        _kernel("cudnn_fprop", 300 * us, 8 * us, linked=3),
        _kernel("welford_reduce", 310 * us, 4 * us, linked=5),
        _kernel("max_pool3d_fwd", 320 * us, 6 * us, linked=7),
        _kernel("add_kernel", 330 * us, 1 * us, linked=8),
        _kernel("empty_like_fill", 399 * us, 1 * us, linked=12),
        _kernel("maxpool_bwd_kernel", 400 * us, 9 * us, linked=10, corr=901),
        _kernel("bn_bw", 420 * us, 3 * us, linked=14),
        _kernel("cudnn_dgrad", 430 * us, 7 * us, linked=16),
        _event("vgs.stem", 300 * us, 14 * us, device=True, annotation=True),
        _event("Optimizer.step#SGD.step", 500 * us, 5 * us, device=True, annotation=True),
    ]


def test_own_time_total_time_and_the_backward_by_sequence_number():
    out = reduce_op_spans(_synthetic(), steps=1)
    ms = 1e-3
    assert out["op_ms"] == {
        "stem": pytest.approx(8 * ms), "batch_norm": pytest.approx(4 * ms),
        "maxpool_fwd": pytest.approx(6 * ms), "maxpool_bwd": pytest.approx(10 * ms),
        "batch_norm.bwd": pytest.approx(3 * ms), "stem.bwd": pytest.approx(7 * ms)}
    assert out["op_total_ms"] == {
        "stem": pytest.approx(12 * ms), "batch_norm": pytest.approx(4 * ms),
        "maxpool_fwd": pytest.approx(6 * ms), "maxpool_bwd": pytest.approx(10 * ms),
        "batch_norm.bwd": pytest.approx(3 * ms), "stem.bwd": pytest.approx(10 * ms)}
    assert out["op_calls"] == {"stem": 1, "batch_norm": 1, "maxpool_fwd": 1, "maxpool_bwd": 1}


def test_every_device_operation_is_attributed_once():
    events = _synthetic()
    _, ops = attribute(events)
    work = [e for e in events if e.device_type() == CUDA and not e.is_user_annotation()]
    assert sorted(n for n, *_ in ops) == sorted(e.name() for e in work)
    own = {n: span for n, _, span, _ in ops}
    assert own["add_kernel"] is None                 # launched outside every span
    out = reduce_op_spans(events, steps=2)
    attributed = sum(e.duration_ns() for e in work if e.name() != "add_kernel") / 1e6 / 2
    assert sum(out["op_ms"].values()) == pytest.approx(attributed)


def _profiled_two_layer_events():
    """A real CPU profile of a two-layer model's forward and backward under
    spans, with one device operation per ``aten::mm``/``addmm`` launched by
    it (the CPU profile has none of its own)."""
    torch.manual_seed(0)
    l1, l2 = torch.nn.Linear(4, 8), torch.nn.Linear(8, 2)
    x = torch.randn(3, 4)
    with torch.profiler.profile() as prof:
        with record_function("query_pass"):
            with record_function("vgs.l1"):
                h = l1(x).relu()
            with record_function("vgs.l2"):
                y = l2(h)
        with record_function("backward"):
            y.sum().backward()
    host = list(prof.profiler.kineto_results.events())
    launched = sorted((e for e in host if e.name() in ("aten::addmm", "aten::mm")),
                      key=lambda e: e.start_ns())
    device = [_kernel(f"gemm{i}", e.start_ns(), 1000 * (i + 1), e.correlation_id())
              for i, e in enumerate(launched)]
    return host + device


def test_a_real_cpu_profile_attributes_forward_and_backward():
    events = _profiled_two_layer_events()
    _, ops = attribute(events)
    own = [span for _, _, span, _ in ops]
    # two forward addmm, then each layer's weight and input gradients
    assert own[:2] == ["l1", "l2"]
    assert set(own[2:]) == {"l1.bwd", "l2.bwd"} and None not in own
    out = reduce_op_spans(events, steps=1)
    assert out["op_calls"] == {"l1": 1, "l2": 1}
    assert sum(out["op_ms"].values()) == pytest.approx(sum(d for _, d, _, _ in ops) / 1e6)


def _as_recorded(events, spans: bool):
    """The synthetic step as the profiler records the program with its spans
    (host ops with no device range, so a kernel launched straight from
    Python inside one links to it) or without them."""
    out = []
    for e in events:
        if e.name().startswith("vgs.") and (e.device_type() == CUDA or not spans):
            continue
        if e.name() == "maxpool_bwd_kernel":
            e = _kernel(e.name(), e.start_ns(), e.duration_ns(), linked=11 if spans else 10,
                        corr=901)
        out.append(e)
    return out


def test_reduce_events_reads_the_same_with_and_without_the_op_spans():
    phases = ("query_pass", "backward")
    with_spans, plain = _as_recorded(_synthetic(), True), _as_recorded(_synthetic(), False)
    assert (reduce_events(with_spans, phases, CLASSES, steps=1)
            == reduce_events(plain, phases, CLASSES, steps=1))
    assert reduce_op_spans(with_spans, steps=1) == reduce_op_spans(_synthetic(), steps=1)
    assert reduce_op_spans(plain, steps=1) == {"op_ms": {}, "op_total_ms": {}, "op_calls": {}}


@pytest.mark.cuda
def test_hand_written_kernels_lie_under_their_spans(cuda, monkeypatch):
    """One traced step of the S3D cell at bs 8: every K1, K2 and K3/K4
    kernel under its own span, none outside; the spans' entries are the
    wrappers' calls of a MoCo step (K1 6, K2 9, K3 + K4 13)."""
    from portbench.core import trace
    from portbench.drivers import pretrain as drv

    from conftest import tiny

    cell = tiny(resolve("s3d_gca.moco_112_b256"), dtype="bfloat16", batch=8)
    cell.settings.update({"INPUT.VIDEO_LENGTH": 16, "INPUT.SCALE_SIZE": [128, 128],
                          "INPUT.BASE_SIZE": [112, 112], "CONTRAST.NCE_K": 1024})
    cell.traffic["trace_steps"] = 1
    captured = []
    kineto = trace.kineto_events

    def keep(prof):
        captured.extend(kineto(prof))
        return captured

    monkeypatch.setattr(trace, "kineto_events", keep)
    out = drv.run(cell, drv.Opts(seed=2 ** 31 + 99, seconds=1.0, trace=True,
                                 t_start=time.perf_counter()))
    want = {K1: "graph_adjacency", K2: "gcn_propagate", K34: "maxpool_bwd"}
    patterns = dict(CLASSES)
    _, ops = attribute(captured)
    found = {k: 0 for k in want}
    for name, _, span, _ in ops:
        for kernel, owner in want.items():
            if re.search(patterns[kernel], name.lower()):
                assert span == owner, (name, span)
                found[kernel] += 1
    assert all(found.values()), found
    # the spans leave the device's timeline as it was: no range of their own
    assert not [e.name() for e in captured
                if e.device_type() != CPU and e.name().startswith("vgs.")]
    assert out["summary"]["busy_s"] > 0
    calls = reduce_op_spans(captured, 1)["op_calls"]
    assert (calls["graph_adjacency"], calls["gcn_propagate"], calls["maxpool_bwd"]) == (6, 9, 13)
