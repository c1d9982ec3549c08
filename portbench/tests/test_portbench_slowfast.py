"""The SlowFast cell (``slowfast_r50_gca.moco_224_t32_b64``) on the CPU: a
tiny MoCo step of the configuration against the plain reference, the shape
walk at the cell's size (3 graph blocks at T = 32, the 2 stem pools), the
recomputed reference against the plain one, the shared metric readers
on the cell's summary, and the lateral fusions' op span in a profiled pass."""

import time

import pytest
import torch

from portbench.core.cells import resolve
from portbench.core.op_spans import reduce_op_spans
from portbench.drivers import pretrain as drv
from portbench.metrics import _flops, _shapes
from portbench.metrics import graph_kernels_roofline, step_mfu
from portbench.reference import slowfast as ref_slowfast
from portbench.reference.models import build_model, make_weights, weight_specs

from conftest import tiny
from test_portbench_step import CPU_LIMITS, _check64

CELL = "slowfast_r50_gca.moco_224_t32_b64"


def tiny_slowfast(**kw):
    """The cell at 32 frames of 32x32 (every graph block still at T = 32)."""
    cell = tiny(resolve(CELL), **kw)
    cell.settings.update({"INPUT.VIDEO_LENGTH": 32, "INPUT.SCALE_SIZE": [36, 36],
                          "INPUT.BASE_SIZE": [32, 32]})
    return cell


def test_moco_step_matches_the_reference(monkeypatch):
    monkeypatch.setattr(drv, "check", _check64)
    out = drv.run(tiny_slowfast(), drv.Opts(seed=2 ** 31 + 23, seconds=0.2, trace=False,
                                            t_start=time.perf_counter(), device="cpu"))
    numbers = {k: v[0] for k, v in out["numbers"].items()}
    print(numbers)
    assert all(numbers[k] < CPU_LIMITS[k]["limit"] for k in CPU_LIMITS)
    assert out["steps"] >= 1 and out["metrics"]["clips_per_s"] > 0


def test_shape_walk_at_the_cells_size():
    shapes = _shapes.pass_shapes(resolve(CELL).settings)
    assert shapes["pools"] == [((64, 64, 8, 112, 112), (64, 64, 8, 56, 56)),
                               ((64, 8, 32, 112, 112), (64, 8, 32, 56, 56))]
    assert shapes["graphs"] == [((64, 32, 12544), (64, 32, 56, 56, 32)),
                                ((64, 32, 6272), (64, 32, 28, 28, 64)),
                                ((64, 32, 3136), (64, 32, 14, 14, 128))]


def test_recomputed_reference_equals_the_plain_one(monkeypatch):
    x = torch.randn(2, 32, 32, 32, 3, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    out = []
    for recompute in (False, True):
        monkeypatch.setattr(ref_slowfast.SlowFast, "recompute", recompute)
        ref = build_model("slowfast_r50", (2, 3, 4), 32).double().train()
        w0 = make_weights(weight_specs(ref), 5, "cpu")
        with torch.no_grad():
            for n, p in ref.named_parameters():
                p.copy_(w0[n])
        y = ref.model.encoder(x, 7)
        y.square().sum().backward()
        out.append((y.detach(), {n: p.grad for n, p in ref.named_parameters()
                                 if p.grad is not None},
                    {n: b.clone() for n, b in ref.named_buffers()}))
    (y0, g0, b0), (y1, g1, b1) = out
    assert torch.equal(y0, y1) and g0.keys() == g1.keys() and b0.keys() == b1.keys()
    for n in g0:
        assert torch.allclose(g0[n], g1[n], rtol=1e-12, atol=1e-14), n
    # the running statistics are the first forward's: the recompute restored them
    for n in b0:
        assert torch.equal(b0[n], b1[n]), n


def _summary(settings):
    from portbench.metrics._classes import K1, K2

    return {"settings": settings, "ranks": 1, "regime": "moco",
            "passes": {"forward": 2, "backward": 1}, "steps": 10, "busy_s": 3.0,
            "span_ms": {"backward": 120.0}, "class_ms": {K1: 0.5, K2: 2.5},
            "untraced": {"steps": 100, "window_s": 40.0}}


def test_the_shared_readers_on_the_cells_summary():
    from portbench.core.cells import load_reader

    cell = resolve(CELL)
    names = [m["name"] for m in cell.per_layer]
    assert "graph_kernels_roofline" in names and "step_mfu" in names
    summary = _summary(cell.settings)
    roofline, mfu = (load_reader(cell, n) for n in ("graph_kernels_roofline", "step_mfu"))
    # K1/K2's bound at T = 32 over 3 ms of K1 and K2 a step
    assert roofline(summary) == pytest.approx(graph_kernels_roofline.read(summary))
    assert 0 < roofline(summary) < 100
    # 100 steps of 25.76 TFLOP in 40 s: 6.5% of 989 TFLOP/s
    assert _flops.moco_step_flops(cell.settings) == pytest.approx(25.757e12, rel=1e-3)
    assert mfu(summary) == pytest.approx(step_mfu.read(summary)) == pytest.approx(6.51, rel=1e-2)


def test_fuse_spans_four_calls_a_pass():
    from video_graph_ssl_tpu_torch.models.build import create_visual_model
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    cell = tiny_slowfast(dtype="float32", batch=1)
    model = create_visual_model(load_config("", drv.overrides(cell.settings, 1)))[0].train()
    x = torch.randn(1, 32, 32, 32, 3)
    with torch.profiler.profile() as prof:
        for seed in range(2):
            model.model.encoder(x, graph_seed=seed)
    calls = reduce_op_spans(prof.profiler.kineto_results.events(), steps=2)["op_calls"]
    assert calls["fuse"] == 4 and calls["stem"] == 1 and calls["graph_block"] == 3
    assert calls["maxpool_fwd"] == 2
