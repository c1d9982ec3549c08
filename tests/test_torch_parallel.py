"""The port's multi-GPU pieces on the CPU (``video_graph_ssl_tpu_torch/parallel``,
the ``Loader``'s ``batch_slice``, the row windows of the step's draws).

Ranks are processes over gloo (``tests/_torch_dist_util.py``: ``spawn``,
``file://`` rendezvous in the test's directory, a timeout per process).

* Cross-rank BN: two ranks against one process's BN over the concatenated
  batch, float64, channel dim 1 and -1, the process's BN in its default
  statistics and in ``sum_form_bn``: output and input gradient to 1e-10
  (float64; the default computes the variance by another formula); the sum
  of the ranks' weight and bias gradients and the running statistics, held
  in the parameters' fp32, to 1e-6.
* The ``Loader`` with ``batch_slice`` against the JAX ``Loader`` with the
  same slice, bit for bit over two epochs, and its validation errors.
* Row windows: the plain uniform and gaussian graph noise and the SSL
  augmentation's parameters and output for rows [lo, hi) equal those rows
  of the global batch's, bit for bit.
* ShuffleBN with an injected permutation against a one-process emulation
  (split, per-split BN, averaged statistics), and against the JAX package's
  ``shuffle_bn_apply`` on a two-device CPU mesh in a subprocess, both at
  1e-5 rel-L2 (fp32, tiny3d + a graph block).
* Without a process group the helpers are the identity.
"""

import contextlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_dist_util as du
from _torch_port_util import rel_l2
from video_graph_ssl_tpu.data.pipeline import Loader as JaxLoader
from video_graph_ssl_tpu_torch.data import build as pbuild
from video_graph_ssl_tpu_torch.data import transforms_device as td
from video_graph_ssl_tpu_torch.data.pipeline import Loader
from video_graph_ssl_tpu_torch.models.layers import BatchNorm
from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
from video_graph_ssl_tpu_torch.ops import temporal_graph as tg
from video_graph_ssl_tpu_torch.parallel import dist

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------- #
# cross-rank BN
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("reference", ["native", "sum_form"])
@pytest.mark.parametrize("channel_dim", [1, -1])
def test_sync_bn_matches_bn_over_the_concatenated_batch(tmp_path, channel_dim, reference):
    """Against one process's BN: its default ``native_batch_norm``
    statistics, and ``sum_form_bn``, the ranks' own function without a
    reduction."""
    from video_graph_ssl_tpu_torch.parallel.sync_bn import sum_form_bn

    g = np.random.default_rng(0)
    shape = (4, 6, 3, 5, 5) if channel_dim == 1 else (4, 3, 5, 5, 6)
    x = (g.standard_normal(shape) * 2.0 + 0.7).astype(np.float64)
    cot = g.standard_normal(shape)
    w, b = g.uniform(0.5, 1.5, 6).astype(np.float32), g.standard_normal(6).astype(np.float32)
    ranks = du.run_ranks(du.bn_worker, 2, tmp_path, x, cot, channel_dim, w, b)

    bn = BatchNorm(6, momentum=0.9, eps=1e-3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_()
    with sum_form_bn(bn) if reference == "sum_form" else contextlib.nullcontext():
        assert bn.sum_form == (reference == "sum_form")
        y = bn(xt, channel_dim=channel_dim)
    assert not bn.sum_form
    (y * torch.from_numpy(cot)).sum().backward()

    tol = 1e-10
    assert rel_l2(np.concatenate([r["y"] for r in ranks]), y.detach().numpy()) < tol
    assert rel_l2(np.concatenate([r["dx"] for r in ranks]), xt.grad.numpy()) < tol
    assert rel_l2(sum(r["dw"] for r in ranks), bn.weight.grad.numpy()) < 1e-6
    assert rel_l2(sum(r["db"] for r in ranks), bn.bias.grad.numpy()) < 1e-6
    for r in ranks:   # fp32 buffers, the same global update on every rank
        np.testing.assert_array_equal(r["mean"], ranks[0]["mean"])
        np.testing.assert_array_equal(r["var"], ranks[0]["var"])
        assert rel_l2(r["mean"], bn.running_mean.numpy()) < 1e-6
        assert rel_l2(r["var"], bn.running_var.numpy()) < 1e-6


def test_per_rank_bn_keeps_the_rank_statistics():
    """``per_rank_bn`` (ShuffleBN's key pass) restores the global mode."""
    from video_graph_ssl_tpu_torch.parallel.sync_bn import bn_buffers, per_rank_bn

    bn = torch.nn.Sequential(BatchNorm(3, 0.9, 1e-3), BatchNorm(3, 0.9, 1e-3))
    with per_rank_bn(bn):
        assert all(m.per_rank for m in bn)
    assert not any(m.per_rank for m in bn)
    assert len(bn_buffers(bn)) == 4


# --------------------------------------------------------------------------- #
# the Loader's batch_slice
# --------------------------------------------------------------------------- #
class _DS:
    """Items whose pixels come from the per-item rng, as real datasets' do."""

    def __len__(self):
        return 18

    def __getitem__(self, i, rng=None):
        return {"clips": rng.integers(0, 256, (2, 3), np.uint8),
                "index": np.asarray(i)}


@pytest.mark.parametrize("batch_slice", [(0, 2), (2, 4), (1, 3)])
def test_loader_batch_slice_matches_jax(batch_slice):
    ours = Loader(_DS(), batch_size=4, num_workers=2, seed=3, batch_slice=batch_slice)
    ref = JaxLoader(_DS(), batch_size=4, num_workers=2, seed=3, batch_slice=batch_slice)
    full = Loader(_DS(), batch_size=4, num_workers=2, seed=3)
    lo, hi = batch_slice
    for epoch in (0, 1):
        got, want, whole = (list(x.epoch(epoch)) for x in (ours, ref, full))
        assert len(got) == len(want) == len(whole) == 4
        for a, b, c in zip(got, want, whole):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(a[k], c[k][lo:hi])


@pytest.mark.parametrize("kw", [dict(batch_slice=(2, 6)), dict(batch_slice=(3, 3)),
                                dict(batch_slice=(0, 2), drop_last=False)])
def test_loader_batch_slice_validation_matches_jax(kw):
    for cls in (Loader, JaxLoader):
        with pytest.raises(ValueError):
            cls(_DS(), batch_size=4, **kw)


def test_factory_passes_batch_slice():
    loader, n = pbuild.build_video_contrastive_loader(du.port_cfg(), batch_slice=(1, 3))
    full, _ = pbuild.build_video_contrastive_loader(du.port_cfg())
    assert n == 32 and loader.batch_slice == (1, 3)
    a, b = next(iter(loader.epoch(0))), next(iter(full.epoch(0)))
    np.testing.assert_array_equal(a["clips"], b["clips"][1:3])


# --------------------------------------------------------------------------- #
# row windows of the draws
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("world", [2, 4])
def test_graph_noise_rows_equal_the_global_draw(world):
    B, T = 8, 4
    full_u = gk.draw_uniform((B, T, T), 123, "cpu")
    for r in range(world):
        s = du.rows(r, world, B)
        u = gk.draw_uniform((B // world, T, T), 123, "cpu", rows=(s.start, B))
        assert torch.equal(u, full_u[s])
    with pytest.raises(ValueError):
        gk.draw_uniform((4, T, T), 1, "cpu", rows=(6, 8))


@pytest.mark.parametrize("sampler", ["relaxed_bernoulli", "gaussian"])
def test_graph_block_rows_equal_the_global_batch(sampler):
    """The block's noise on rows [lo, hi) is those rows of the global draw:
    its output on the rows equals the global batch's rows (to fp32
    rounding: the adjacency is fp32, and the CPU's batched products of 2 or
    3 clips may round otherwise than of 6)."""
    torch.manual_seed(0)
    block = tg.TemporalGraphAug(8, dtype=torch.float64, sampler=sampler).double().train()
    x = torch.randn(6, 4, 4, 4, 8, dtype=torch.float64)
    full = block(x, seed=77)
    for lo, hi in ((0, 3), (3, 6), (2, 4)):
        part = block(x[lo:hi], seed=77, rows=(lo, 6))
        torch.testing.assert_close(part, full[lo:hi], rtol=1e-5, atol=1e-6)
    other = block(x[2:4], seed=77)   # local clips 0, 1: another draw
    assert not torch.allclose(other, full[2:4])


@pytest.mark.parametrize("b,v,world", [(4, 2, 2), (3, 2, 3), (8, 2, 4)])
def test_ssl_params_rows_and_augment_equal_the_global_batch(b, v, world):
    """Each rank draws the global batch's parameters and applies its rows;
    jitter groups may straddle ranks ((3, 2, 3): groups of 3 clip-views,
    ranks of 2)."""
    g = np.random.default_rng(1)
    clips = torch.from_numpy(g.integers(0, 256, (b, v, 4, 20, 20, 3), np.uint8))
    gen = torch.Generator().manual_seed(5)
    params = td.draw_ssl_params(b * v, (20, 20), gen, "cpu")
    full = td.apply_ssl_augment(clips, params, (16, 16), (0.4, 0.4, 0.4), (0.2, 0.2, 0.2))
    per = b // world
    for r in range(world):
        lo, hi = r * per, (r + 1) * per
        p = params.rows(lo * v, hi * v)
        assert torch.equal(p.box, params.box[lo * v:hi * v])
        part = td.apply_ssl_augment(clips[lo:hi], p, (16, 16), (0.4, 0.4, 0.4),
                                    (0.2, 0.2, 0.2))
        assert torch.equal(part, full[lo:hi])


def test_fused_augment_fn_rows_equal_the_global_batch():
    c = du.port_cfg()
    fn = td.make_batch_augment_fn(c, "ssl")
    clips = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, 2, 4, 20, 20, 3), np.uint8))
    full = fn(torch.Generator().manual_seed(9), clips)
    assert torch.equal(fn(torch.Generator().manual_seed(9), clips, (0, 4)), full)
    for lo in (0, 2):
        part = fn(torch.Generator().manual_seed(9), clips[lo:lo + 2], (lo, 4))
        assert torch.equal(part, full[lo:lo + 2])


@pytest.mark.cuda
def test_k1_clip_offset_draws_the_global_rows():
    """On the card: K1's in-kernel draw with clip0 = r * B / W over the
    local rows equals the full batch's draw on those rows, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    B, T, D = 16, 8, 96
    q = torch.randn(B, T, D, device=dev)
    theta = torch.from_numpy(tg.hop_weight_matrix(T, 3, 0.5)).to(dev)
    u_full = torch.empty(B, T, T, device=dev)
    gk.adjacency_fwd_kernel(q, q, theta, None, 11, 1.0, True, 0, u_out=u_full)
    for lo in (0, 8):
        u = torch.empty(8, T, T, device=dev)
        gk.adjacency_fwd_kernel(q[lo:lo + 8], q[lo:lo + 8], theta, None, 11, 1.0, True, 0,
                                u_out=u, rows=(lo, B))
        assert torch.equal(u, u_full[lo:lo + 8])


# --------------------------------------------------------------------------- #
# ShuffleBN
# --------------------------------------------------------------------------- #
SHUFFLE_OPTS = ["GRAPH.SAMPLER", "none"]


def _shuffle_emulation(state_dict, x, perm, seed):
    """One process: shuffle, run each rank's rows with its own BN
    statistics from the same initial state, average the BN buffers."""
    from video_graph_ssl_tpu_torch.parallel.sync_bn import bn_buffers

    xs = torch.from_numpy(x)[torch.from_numpy(perm)]
    feats, bufs, state = [], [], None
    for part in xs.chunk(2):
        model = du._model(SHUFFLE_OPTS, state_dict).train()
        with torch.no_grad():
            feats.append(model(part, graph_seed=seed))
        bufs.append([b.clone() for b in bn_buffers(model)])
        state = model
    with torch.no_grad():
        for b, *per in zip(bn_buffers(state), *bufs):
            b.copy_(sum(per) / len(per))
    keys = torch.cat(feats)[torch.argsort(torch.from_numpy(perm))]
    return keys.numpy(), {k: v.numpy() for k, v in state.state_dict().items()}


def test_shuffle_bn_matches_a_one_process_emulation(tmp_path):
    model = du._model(SHUFFLE_OPTS, None)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    x = np.random.default_rng(3).standard_normal((4, 4, 16, 16, 3)).astype(np.float32)
    perm = np.array([2, 0, 3, 1])
    ranks = du.run_ranks(du.shuffle_worker, 2, tmp_path, SHUFFLE_OPTS, sd, x, perm, 5)
    keys, state = _shuffle_emulation(sd, x, perm, 5)
    for r in ranks:
        assert rel_l2(r["keys"], keys) < 1e-5
        for k in state:
            assert rel_l2(r["state"][k], state[k]) < 1e-5, k
            np.testing.assert_array_equal(r["state"][k], ranks[0]["state"][k])
    # the shuffle matters: without it the same model gives other keys
    plain = du._model(SHUFFLE_OPTS, sd).train()
    with torch.no_grad():
        unshuffled = torch.cat([plain(p, graph_seed=5) for p in torch.from_numpy(x).chunk(2)])
    assert rel_l2(unshuffled.numpy(), keys) > 1e-3


JAX_SHUFFLE = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import jax, jax.numpy as jnp
    from video_graph_ssl_tpu.config import cfg as CFG
    from video_graph_ssl_tpu.engine import create_pretrain_state
    from video_graph_ssl_tpu.models import create_visual_model
    from video_graph_ssl_tpu.parallel import make_mesh
    from video_graph_ssl_tpu.parallel.shuffle_bn import shuffle_bn_apply
    from video_graph_ssl_tpu_torch.utils.jax_weights import pretrain_state_dict

    assert len(jax.devices()) == 2, jax.devices()
    c = CFG.clone()
    c.merge_from_list({opts!r})
    x = np.load({x!r})
    model, _ = create_visual_model(c)
    state, _ = create_pretrain_state(c, model, jnp.asarray(x[:2]), n_data=8)
    key = jax.random.PRNGKey(7)
    mesh = make_mesh((-1,), ("data",))
    fn = jax.jit(lambda p, s, xx: shuffle_bn_apply(model, p, s, xx, key, mesh))
    feat, stats = fn(state.ema_params, state.ema_batch_stats, jnp.asarray(x))
    out = dict(perm=np.asarray(jax.random.permutation(key, x.shape[0])),
               keys=np.asarray(feat))
    for tag, st in (("init", state.ema_batch_stats), ("new", stats)):
        for k, v in pretrain_state_dict(state.ema_params, st, c.MODEL.BACKBONE).items():
            out[tag + "/" + k] = np.asarray(v)
    np.savez({out!r}, **out)
    print("ok")
""")


def test_shuffle_bn_matches_jax_two_device_mesh(tmp_path):
    """The two-rank key pass against ``shuffle_bn_apply`` under ``shard_map``
    on a two-device CPU mesh, from the same EMA weights and permutation."""
    x = np.random.default_rng(4).standard_normal((4, 4, 16, 16, 3)).astype(np.float32)
    xp, out = str(tmp_path / "x.npy"), str(tmp_path / "jax.npz")
    np.save(xp, x)
    opts = ["MODEL.BACKBONE", "tiny3d", "MODEL.BACKBONE_TYPE", "3D", "MODEL.AUG_FLAG", True, "MODEL.DROPOUT", 0.0,
            "INPUT.VIDEO_LENGTH", 4, "CONTRAST.MEM_TYPE", "moco", "CONTRAST.NCE_K", 16,
            "CROSS.FEAT_DIM", 32, "TPU.COMPUTE_DTYPE", "float32", "GRAPH.SAMPLER", "none"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_NUM_CPU_DEVICES="2",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    res = subprocess.run([sys.executable, "-c", JAX_SHUFFLE.format(
        repo=REPO, opts=opts, x=xp, out=out)], capture_output=True, text=True,
        timeout=240, env=env)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-4000:]
    ref = np.load(out)
    init = {k[5:]: ref[k] for k in ref.files if k.startswith("init/")}
    ranks = du.run_ranks(du.shuffle_worker, 2, tmp_path, SHUFFLE_OPTS, init, x,
                         ref["perm"], 0)
    new = {k[4:]: ref[k] for k in ref.files if k.startswith("new/")}
    bn_keys = [k for k in new if k.endswith(("running_mean", "running_var"))]
    assert bn_keys
    for r in ranks:
        assert rel_l2(r["keys"], ref["keys"]) < 1e-5
        for k in bn_keys:
            assert rel_l2(r["state"][k], new[k]) < 1e-5, k


# --------------------------------------------------------------------------- #
# no process group
# --------------------------------------------------------------------------- #
def test_helpers_without_a_group_are_the_identity():
    x = torch.randn(3, 2)
    m = {"loss": torch.tensor(1.5)}
    assert not dist.is_distributed() and dist.rank() == 0 and dist.world_size() == 1
    assert dist.all_gather_rows(x) is x
    assert dist.mean_over_ranks(m) is m
    assert dist.process_batch_slice(8) == (0, 8)
    assert dist.any_rank(True) and not dist.any_rank(False)
    dist.check_replicated([x], "x")
    dist.average_([x])
    dist.barrier()


def test_process_batch_slice_raises_on_an_unequal_share(monkeypatch):
    monkeypatch.setattr(dist, "world_size", lambda: 3)
    monkeypatch.setattr(dist, "rank", lambda: 2)
    assert dist.process_batch_slice(12) == (8, 12)
    with pytest.raises(ValueError):
        dist.process_batch_slice(8)


def test_init_without_a_rendezvous_raises(monkeypatch):
    for v in dist.TORCHRUN_VARS:
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(RuntimeError):
        dist.init_distributed("gloo")
    with pytest.raises(ValueError):
        dist.init_distributed("gloo", "file:///nonexistent", world=2)


def test_backbone_stages_pass_the_rows_to_the_graph_blocks():
    """S3D's ``run_stages`` hands every graph block the pass's row window
    (tiny3d's is held by the step tests)."""
    from video_graph_ssl_tpu_torch.models.s3d import run_stages

    seen = []

    class Spy(torch.nn.Module):
        def forward(self, x, seed=0, rows=None):
            seen.append(rows)
            return x

    base = torch.nn.Sequential(torch.nn.Identity(),
                               torch.nn.Sequential(Spy(), torch.nn.Identity()),
                               torch.nn.Sequential(Spy(), torch.nn.Identity()))
    run_stages(base, torch.zeros(2, 3, 4, 4, 4), (1, 2), 5, rows=(2, 8))
    assert seen == [(2, 8), (2, 8)]
