"""The port's op-level spans and counters (``utils/tracing.py``): a span is
no ``record_function`` while no profiler runs; under a CPU profiler one
fused MoCo step of the tiny 3D backbone opens every span, nested as the
layers nest, and enters K1's, K2's and the max-pool backward's spans as
often as ``kernel_times.step_calls`` counts those kernels' calls; the
counter registry counts and resets."""

import collections

import pytest
import torch

from video_graph_ssl_tpu_torch import graph_benefit as gb
from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
from video_graph_ssl_tpu_torch.engine.pretrain import make_fused_pretrain_step
from video_graph_ssl_tpu_torch.kernel_times import step_calls
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.utils import tracing

SPANS = ("stem", "batch_norm", "maxpool_fwd", "maxpool_bwd", "graph_block",
         "graph_adjacency", "gcn_propagate")


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

    monkeypatch.setattr(tracing, "_RecordFunctionFast", Spy)
    assert not torch.autograd._profiler_enabled()
    with tracing.span("stem") as ctx:
        assert ctx is None
    assert tracing.span("batch_norm") is tracing.OFF and entered == []
    with torch.profiler.profile():
        assert isinstance(tracing.span("stem"), Spy)
    assert entered == ["vgs.stem"]


@pytest.fixture(scope="module")
def step_events():
    """The CPU profile of the second fused MoCo step of tiny3d with its
    graph block at 1 (one stride-2 pool)."""
    torch.manual_seed(0)
    c = gb.make_cfg("moco", True, 8, 16)
    model, _ = create_visual_model(c)
    state = create_pretrain_state(c, model, "cpu", n_data=16)
    step = make_fused_pretrain_step(c)
    raw = torch.randint(0, 256, (4, 2, 8, 20, 20, 3), dtype=torch.uint8)
    step(state, raw, 0.1)
    with torch.profiler.profile() as prof:
        step(state, raw, 0.1)
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


def _spans(events):
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(tracing.PREFIX):])
            for e in events if e.name().startswith(tracing.PREFIX)]


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_a_step_opens_every_span_nested_as_the_layers(step_events):
    spans = _spans(step_events)
    # host ops, not user annotations: no range of their own on a device
    assert not [e.name() for e in step_events
                if e.name().startswith(tracing.PREFIX) and e.is_user_annotation()]
    names = collections.Counter(n for _, _, n in spans)
    assert set(SPANS) <= set(names), names
    # two passes: the key pass and the query pass
    assert names["stem"] == 2 and names["graph_block"] == 2 and names["maxpool_fwd"] == 2
    stems = [s for s in spans if s[2] == "stem"]
    blocks = [s for s in spans if s[2] == "graph_block"]
    in_stem = [s for s in spans if s[2] == "batch_norm" and any(_inside(s, t) for t in stems)]
    assert len(in_stem) == 2                           # the stem's BN, in each pass
    assert all(any(_inside(s, b) for b in blocks) for s in spans if s[2] == "graph_adjacency")
    backward = next(e for e in step_events if e.name() == "backward")
    window = (backward.start_ns(), backward.start_ns() + backward.duration_ns())
    # K2's forward in each pass inside its graph block, its dx in the backward
    k2 = [s for s in spans if s[2] == "gcn_propagate"]
    assert sum(any(_inside(s, b) for b in blocks) for s in k2) == 2
    assert sum(_inside(s, window) for s in k2) == 1
    assert all(_inside(s, window) for s in spans if s[2] == "maxpool_bwd")


def test_kernel_spans_are_entered_as_often_as_the_kernels_run(step_events):
    names = collections.Counter(n for _, _, n in _spans(step_events))
    want = step_calls("moco", backbone="tiny3d")
    assert names["graph_adjacency"] == want["graph_adjacency"] == 2
    assert names["gcn_propagate"] == want["gcn_propagate"] == 3
    assert names["maxpool_bwd"] == want["maxpool_bwd_s1"] + want["maxpool_bwd_strided"] == 1


def test_counter_registry_counts_and_resets():
    tracing.reset_counters()
    assert tracing.counters()["gcn_propagate"] == 0
    tracing.count("gcn_propagate")
    tracing.count("gcn_propagate", 2)
    tracing.count("sepconv_bwd_tc", False)
    n = tracing.counters()
    assert n["gcn_propagate"] == 3 and n["sepconv_bwd_tc"] == 0
    n["gcn_propagate"] = 99                            # a copy: the registry keeps its own
    assert tracing.counters()["gcn_propagate"] == 3
    tracing.reset_counters()
    assert tracing.counters() == collections.Counter()
