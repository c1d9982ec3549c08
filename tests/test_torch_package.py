"""Package-level properties of the PyTorch port.

* Importing the port (every module, the shard builder, the native JPEG
  pool's loader, the downstream tools and the graph-benefit runner
  included), building its S3D pretrain and downstream models and states
  and the runner's tiny3d state, and drawing a batch from its loader and
  a probe set never imports JAX, nor the JAX package; the port's copy of the
  config schema equals the JAX package's.
* The kernel wrappers take their plain versions only for CPU tensors; on
  CUDA tensors they launch the kernel or raise (``cuda`` marker: skipped
  where no GPU is present; run them on the card with
  ``python -m pytest -m cuda tests/test_torch_package.py``).
* The trainer entry point runs on the CPU when asked to, and refuses
  ``--device cuda`` without a GPU instead of moving to the CPU.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from video_graph_ssl_tpu_torch import train_video_contrast_dis as train
from video_graph_ssl_tpu_torch.ops import _build
from video_graph_ssl_tpu_torch.ops import fused_sepconv as fs
from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
from video_graph_ssl_tpu_torch.ops import maxpool as mp
from video_graph_ssl_tpu_torch.ops import sepconv_bwd as sb
from video_graph_ssl_tpu_torch.ops.temporal_graph import hop_weight_matrix

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["MODEL.BACKBONE", "tiny3d", "MODEL.AUG_FLAG", "True",
        "DATASET.SOURCE", "synthetic", "DATASET.NUM_CLASS", "4",
        "DATALOADER.BATCH_SIZE", "4", "INPUT.VIDEO_LENGTH", "4",
        "INPUT.SCALE_SIZE", "[20, 20]", "INPUT.BASE_SIZE", "[16, 16]",
        "CONTRAST.NCE_K", "16", "CROSS.FEAT_DIM", "32",
        "CHECKPOINT.PRINT_FREQ", "1"]
# rel-L2 limit of the on-card bf16 pool -> fused-pair gradient against the
# CPU's bf16 graph: 2.3e-4 measured at these inputs on an H100 (one element
# one bf16 step apart), up to 1.1e-3 on other random inputs of this size
BF16_LIMIT = 2e-3


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _reset_counts():
    gk.launches = gp.launches = mp.launches_s1 = mp.launches_strided = sb.launches = 0


def _counts():
    return (gk.launches, gp.launches, mp.launches_s1, mp.launches_strided, sb.launches)


def _backward_inputs(device, dtype=torch.float32):
    """x (B, C, T, H, W) channels_last_3d for a pool and a fused SepConv
    pair, and the pair's parameters (ws, wt, g1, b1, g2, b2)."""
    g = torch.Generator().manual_seed(1)
    c, f = 8, 16
    x = torch.randn(2, c, 4, 6, 6, generator=g)
    params = (torch.randn(f, c, 1, 3, 3, generator=g) / 5,
              torch.randn(f, f, 3, 1, 1, generator=g) / 5,
              1 + 0.1 * torch.randn(f, generator=g), 0.1 * torch.randn(f, generator=g),
              1 + 0.1 * torch.randn(f, generator=g), 0.1 * torch.randn(f, generator=g))
    x = x.to(device, dtype).contiguous(memory_format=torch.channels_last_3d)
    return x, [p.to(device) for p in params]


def _pool_and_pair_backward(x, params, dtype):
    """dx through a stride-1 pool into the fused pair, plus a strided pool
    pair read out directly, under fixed random cotangents (a plain sum of a
    BN output would cancel)."""
    xa = x.clone().requires_grad_()
    out, _ = fs.fused_sepconv_train(mp.max_pool3d(xa, 3, 1, 1), *params, dtype)
    pooled = mp.max_pool3d(mp.max_pool3d(xa, 3, 2, 1), 2, 2, 0)
    g = torch.Generator().manual_seed(2)
    loss = sum((y.double() * torch.randn(y.shape, generator=g, dtype=torch.float64)
                .to(y.device)).sum() for y in (out, pooled))
    loss.backward()
    return xa.grad


def _inputs(device, b=3, t=8, d=40, shape=(3, 8, 2, 3, 16)):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, t, d, generator=g).to(device)
    k = torch.randn(b, t, d, generator=g).to(device)
    theta = torch.from_numpy(hop_weight_matrix(t, 3, 0.5)).to(device)
    adj = torch.rand(shape[0], shape[1], shape[1], generator=g).to(device)
    x = torch.randn(shape, generator=g).to(device)
    return q, k, theta, adj, x


def test_port_never_imports_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from video_graph_ssl_tpu_torch.train_video_contrast_dis import load_config
        from video_graph_ssl_tpu_torch.models.build import create_visual_model
        from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
        from video_graph_ssl_tpu_torch.engine.pretrain import make_fused_pretrain_step
        from video_graph_ssl_tpu_torch.utils import jax_weights
        import video_graph_ssl_tpu_torch.ops._build
        import video_graph_ssl_tpu_torch.ops.maxpool
        import video_graph_ssl_tpu_torch.ops.sepconv_bwd
        import video_graph_ssl_tpu_torch.profile_step
        import video_graph_ssl_tpu_torch.kernel_times
        import video_graph_ssl_tpu_torch.build_shards
        import video_graph_ssl_tpu_torch.data
        from video_graph_ssl_tpu_torch.data import (build, datasets, decode, pipeline,
                                                    records, samplers, shards, synthetic)
        from video_graph_ssl_tpu_torch.data.native import native_jpeg_available
        from video_graph_ssl_tpu_torch.utils import checkpoint, meters, saver, summary
        from video_graph_ssl_tpu_torch.parallel import dist, shuffle_bn, sync_bn
        from video_graph_ssl_tpu_torch import graph_benefit, test_ds, train_ds, video_retrieval
        from video_graph_ssl_tpu_torch.engine.build import create_downstream_state
        from video_graph_ssl_tpu_torch.engine.downstream import make_fused_downstream_step
        from video_graph_ssl_tpu_torch.models.build import create_video_model
        native_jpeg_available()      # the native pool's build-and-load path
        cfg_file = {os.path.join(REPO, 'configs', 'visual_moco.yaml')!r}
        create_visual_model(load_config(cfg_file, ['TPU.SEPCONV_FUSED', 'True']))
        c = load_config(cfg_file, ['MODEL.AUG_FLAG', 'True', 'CONTRAST.NCE_K', '256'])
        model, dim = create_visual_model(c)
        state = create_pretrain_state(c, model, 'cpu')
        make_fused_pretrain_step(c)
        loader, _ = build.build_video_contrastive_loader(load_config(cfg_file, [
            'DATASET.SOURCE', 'synthetic', 'DATASET.NUM_CLASS', '2',
            'DATALOADER.BATCH_SIZE', '2', 'INPUT.SCALE_SIZE', '[8, 8]']))
        batches = loader.epoch(0)
        assert next(batches)['clips'].shape == (2, 2, 16, 8, 8, 3)
        batches.close()
        assert dim == 1024 and len(model.model.encoder.base_model.aug_points) == 3
        ft = load_config({os.path.join(REPO, 'configs', 'action_fine_tune.yaml')!r}, [])
        create_downstream_state(ft, create_video_model(ft)[0], 'cpu')
        make_fused_downstream_step(ft)
        ab = graph_benefit.make_cfg('bank', True, 8, 16)
        create_pretrain_state(ab, create_visual_model(ab)[0], 'cpu', n_data=48)
        assert synthetic.temporal_shortcut_clips(per_class=1)[0].shape == (4, 2, 8, 16, 16, 3)
        bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))
        assert not bad, bad
        jax_pkg = sorted(m for m in sys.modules if m.split('.')[0] == 'video_graph_ssl_tpu')
        assert not jax_pkg, jax_pkg
        print('ok')
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("yaml_file", [None, "visual_moco.yaml", "smoke_simsiam.yaml"])
def test_config_schema_equals_jax(yaml_file):
    from video_graph_ssl_tpu.config import cfg as jax_cfg
    from video_graph_ssl_tpu_torch.config import cfg as port_cfg

    ours, ref = port_cfg.clone(), jax_cfg.clone()
    if yaml_file:
        for c in (ours, ref):
            c.merge_from_file(os.path.join(REPO, "configs", yaml_file))
            c.merge_from_list(["MODEL.AUG_FLAG", "True", "GRAPH.AUG_POINTS", "[5, 9]"])
    assert ours.to_dict() == ref.to_dict()


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On the CPU the wrappers run their plain versions and never reach the
    kernel library (made unloadable here)."""
    def absent():
        raise RuntimeError("kernel library absent")

    monkeypatch.setattr(_build, "library", absent)
    _reset_counts()
    q, k, theta, adj, x = _inputs("cpu")
    out = gk.graph_adjacency(q, k, theta, seed=3)
    assert out.shape == (3, 8, 8) and out.dtype == torch.float32
    assert torch.equal(gp.gcn_propagate(adj, x), gp.propagate_plain(adj, x))
    xb, params = _backward_inputs("cpu")
    dx = _pool_and_pair_backward(xb, params, torch.float32)
    assert dx.shape == xb.shape and torch.isfinite(dx).all()
    assert _counts() == (0, 0, 0, 0, 0)


@pytest.mark.cuda
def test_cuda_wrappers_raise_without_the_library(monkeypatch):
    """No fallback: on CUDA tensors a wrapper whose library cannot load
    raises, and counts no launch."""
    dev = _cuda()

    def absent():
        raise RuntimeError("kernel library absent")

    monkeypatch.setattr(_build, "library", absent)
    _reset_counts()
    q, k, theta, adj, x = _inputs(dev)
    with pytest.raises(RuntimeError, match="absent"):
        gk.graph_adjacency(q, k, theta, seed=3)
    with pytest.raises(RuntimeError, match="absent"):
        gp.gcn_propagate(adj, x)
    xb, params = _backward_inputs(dev)
    for k3 in (True, False):     # the stride-1 (K3) and a strided (K4) pool
        xa = xb.clone().requires_grad_()
        y = mp.max_pool3d(xa, 3, 1, 1) if k3 else mp.max_pool3d(xa, 3, 2, 1)
        with pytest.raises(RuntimeError, match="absent"):
            y.sum().backward()
    xa = xb.clone().requires_grad_()
    out, _ = fs.fused_sepconv_train(xa, *params, torch.float32)
    with pytest.raises(RuntimeError, match="absent"):
        out.sum().backward()
    assert _counts() == (0, 0, 0, 0, 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, theta, adj, x = _inputs(dev)
    gk.launches = gp.launches = 0
    u = torch.rand(3, 8, 8, device=dev) * 0.99 + 0.005
    for sample in (False, True):
        out = gk.graph_adjacency(q, k, theta, sample=sample, u=u)
        ref = gk.graph_adjacency_plain(q, k, theta, sample=sample, u=u)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    for dt in (torch.float32, torch.bfloat16):
        out = gp.gcn_propagate(adj.to(dt), x.to(dt))
        ref = gp.propagate_plain(adj.to(dt), x.to(dt))
        torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2 if dt == torch.bfloat16
                                   else 1e-5, atol=1e-2 if dt == torch.bfloat16 else 1e-5)
    assert gk.launches == 2 and gp.launches == 2
    torch.backends.cudnn.allow_tf32 = False
    for dt in (torch.float32, torch.bfloat16):
        xb, params = _backward_inputs(dev, dt)
        _reset_counts()
        got = _pool_and_pair_backward(xb, params, dt)
        assert _counts() == (0, 0, 1, 2, 1)
        # fp32 against float64 on the CPU; bf16 against the same bf16 graph
        # on the CPU (plain versions), which rounds y1, a, y2, dy2 and dy1
        # at the same points (bf16 against float64 differs by 7e-2 on the
        # CPU alone, so float64 could not hold the bf16 kernels tightly)
        ref_dt = torch.float64 if dt == torch.float32 else dt
        want = _pool_and_pair_backward(xb.cpu().to(ref_dt), [p.cpu() for p in params],
                                       ref_dt).double()
        # rel-L2 of the whole gradient: fp32, summation order; bf16, where
        # cuDNN and the CPU's convolutions sum in other orders, a y1 or y2
        # element may round to the neighbouring bf16 value
        err = float((got.cpu().double() - want).norm() / want.norm())
        print(f"pool -> fused pair dx, {dt}: rel-L2 {err:.3e}")
        assert err < (1e-5 if dt == torch.float32 else BF16_LIMIT), (dt, err)


def test_trainer_runs_on_cpu_when_asked(capsys):
    # options after the overrides, as the README's command writes them
    train.main(["--config_file", os.path.join(REPO, "configs", "visual_moco.yaml"),
                "--device", "cpu", *TINY, "--max_steps", "2"])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("Epoch: [0]")]
    assert len(lines) == 2 and "Loss" in lines[0] and "Prec@1" in lines[0]
    losses = [float(l.split("Loss ")[1].split()[0]) for l in lines]
    assert np.isfinite(losses).all()


def test_trainer_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    c = train.load_config(os.path.join(REPO, "configs", "visual_moco.yaml"), TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.Trainer(c, max_steps=1, device="cuda")
