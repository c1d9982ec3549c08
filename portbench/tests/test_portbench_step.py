"""The program's step at a tiny size on the CPU against the plain reference:
the augmentation, the graph block, both backbones' forwards, and a whole
MoCo step through the harness's own run."""

import time

import pytest
import torch

from portbench.core.cells import resolve
from portbench.drivers import pretrain as drv
from portbench.reference import augment as ref_augment
from portbench.reference.compare import compare
from portbench.reference.graph import TemporalGraphAug as RefGraph
from portbench.reference.models import build_model, make_weights, weight_specs
from portbench.reference.pretrain import run_moco, step_seed

from conftest import tiny


def test_augmentation_draws_and_applies_as_the_program():
    from video_graph_ssl_tpu_torch.data.transforms_device import make_batch_augment_fn
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    cell = tiny(resolve("s3d_gca.moco_112_b256"), dtype="float32", batch=3)
    cfg = load_config("", drv.overrides(cell.settings, 5))
    raw = drv.make_pool(5, 1, drv.batch_shape(cell.settings), "cpu")[0]
    seed = step_seed(7, 0, 2)
    got = make_batch_augment_fn(cfg, "ssl")(torch.Generator().manual_seed(seed), raw)
    want = ref_augment.augment(raw, seed, (64, 64), cell.settings["INPUT.MEAN"],
                               cell.settings["INPUT.STD"])
    assert torch.allclose(got, want, atol=1e-4, rtol=0)


def test_graph_block_matches_the_program_in_float64():
    from video_graph_ssl_tpu_torch.ops.temporal_graph import TemporalGraphAug

    prog, ref = TemporalGraphAug(32, dtype=torch.float64), RefGraph(32).double()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for (n, p), (m, q) in zip(sorted(prog.named_parameters()), sorted(ref.named_parameters())):
            assert n == m
            w = (torch.rand(p.shape, generator=g, dtype=torch.float64) * 2 - 1) * 0.1
            p.copy_(w)
            q.copy_(w)
    x = torch.randn(2, 4, 6, 6, 32, generator=g, dtype=torch.float64)
    dy = torch.randn(x.shape, generator=g, dtype=torch.float64)
    yp, yr = prog(x, seed=99, rows=(0, 2)), ref(x, 99)
    assert torch.allclose(yp, yr, rtol=1e-5, atol=1e-6)
    gp = torch.autograd.grad((yp * dy).sum(), list(dict(sorted(prog.named_parameters())).values()))
    gr = torch.autograd.grad((yr * dy).sum(), list(dict(sorted(ref.named_parameters())).values()))
    # the program rounds its similarity and its propagation to fp32
    for a, b in zip(gp, gr):
        assert float((a.double() - b).norm() / b.norm()) < 1e-5


@pytest.mark.parametrize("workload", ["s3d_gca.moco_112_b256", "i3dnl_r50_gca.moco_112_b256"])
def test_backbone_forward_matches_the_program(workload):
    from video_graph_ssl_tpu_torch.models.build import create_visual_model
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config

    cell = tiny(resolve(workload))
    s = cell.settings
    prog = create_visual_model(load_config("", drv.overrides(s, 3)))[0].eval()
    ref = build_model(s["MODEL.BACKBONE"], s["GRAPH.AUG_POINTS"], 128).double().eval()
    w0 = make_weights(weight_specs(ref), 3, "cpu")
    with torch.no_grad():
        for n, p in prog.named_parameters():
            p.copy_(w0[n])
        for n, p in ref.named_parameters():
            p.copy_(w0[n])
    x = torch.randn(2, 8, 64, 64, 3, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    with torch.no_grad():
        fp = prog.model.encoder(x, graph_seed=0)
        fr = ref.model.encoder(x, 0)
    assert torch.allclose(fp.double(), fr, rtol=1e-5, atol=1e-6)


def _check64(cell, seed, pool, prog, steps):
    return compare(prog, run_moco(cell.settings, seed, pool, steps, dtype=torch.float64),
                   cell.config)


# float64 program and reference on the CPU: the program still rounds its fp32
# head, similarities and propagation, and at this size train-mode BN over a
# few values multiplies that by up to about 1e3
CPU_LIMITS = {"grad_median_gap": {"limit": 1e-3}, "delta_median_gap": {"limit": 1e-3},
              "ema_delta_median_gap": {"limit": 1e-3}, "keys_gap": {"limit": 1e-3},
              "stem_var_gap": {"limit": 1e-3}, "bn_var_median_gap": {"limit": 1e-3}}


def test_moco_step_matches_the_reference(tiny_cell, monkeypatch):
    monkeypatch.setattr(drv, "check", _check64)
    out = drv.run(tiny_cell, drv.Opts(seed=2 ** 31 + 17, seconds=0.2, trace=False,
                                      t_start=time.perf_counter(), device="cpu"))
    numbers = {k: v[0] for k, v in out["numbers"].items()}
    print(numbers)
    assert all(numbers[k] < CPU_LIMITS[k]["limit"] for k in CPU_LIMITS)
    assert out["steps"] >= 1 and out["metrics"]["clips_per_s"] > 0
