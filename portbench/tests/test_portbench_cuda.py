"""On the card: the reference's noise draw and graph block against the
adjacency kernel's, and the control failing each cell's limits at the
cell's own size."""

import json

import pytest
import torch

from portbench.core.cells import ROOT, resolve
from portbench.drivers import pretrain as drv
from portbench.reference.compare import compare, decide
from portbench.reference.graph import TemporalGraphAug as RefGraph
from portbench.reference.graph import philox_uniform
from portbench.reference.pretrain import run_moco

CELLS = [w["name"] for w in json.loads((ROOT.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [None, (3, 9)])
def test_philox_draw_is_the_kernels(cuda, rows):
    from video_graph_ssl_tpu_torch.ops.graph_kernel import adjacency_fwd_kernel
    from video_graph_ssl_tpu_torch.ops.temporal_graph import hop_weight_matrix

    b, t, d, seed = 4, 8, 200, 0x1234_5678_9ABC_DEF0 & 0x7FFF_FFFF_FFFF_FFFF
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(b, t, d, generator=g, device=cuda)
    k = torch.randn(b, t, d, generator=g, device=cuda)
    theta = torch.from_numpy(hop_weight_matrix(t, 3, 0.5)).to(cuda)
    u = torch.empty(b, t, t, device=cuda)
    adjacency_fwd_kernel(q, k, theta, None, seed, 1.0, True, 0, u_out=u, rows=rows)
    want = philox_uniform((b, t, t), seed, rows[0] if rows else 0, cuda)
    assert torch.equal(u, want)


@pytest.mark.cuda
def test_graph_block_matches_the_kernels(cuda):
    from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug

    prog, ref = TemporalGraphAug(64, dtype=torch.float32).to(cuda), RefGraph(64).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for (n, p), (m, r) in zip(sorted(prog.named_parameters()), sorted(ref.named_parameters())):
            w = (torch.rand(p.shape, generator=g, device=cuda) * 2 - 1) * 0.02
            p.copy_(w)
            r.copy_(w)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    x = torch.randn(8, 8, 14, 14, 64, generator=g, device=cuda)
    yp, yr = prog(x, seed=12345), ref(x, 12345)
    assert float((yp - yr).norm() / yr.norm()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits(cuda, workload):
    cell = resolve(workload)
    s, seed = cell.settings, 2 ** 31 + 271
    pool = drv.make_pool(seed, int(cell.traffic["pool_batches"]), drv.batch_shape(s), cuda)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    steps = int(cell.traffic["check_steps"])
    ref = run_moco(s, seed, pool, steps)
    ctl = run_moco(s, seed, pool, steps, rounding="fp8")
    numbers = compare(ctl, ref, cell.config)
    assert not decide(numbers, {n: v["limit"] for n, v in cell.limits.items()}), numbers
