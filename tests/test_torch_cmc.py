"""The port's CMC model and memories (``CROSS.MODALITY cross``) against the JAX
package on the CPU.

* ``temporal_diff`` equals JAX's exactly (and the cases of JAX's
  ``tests/test_cmc.py``: the shape, the front frame).
* ``CmcWrapper`` in eval mode, JAX's variables (``jax.eval_shape`` filled
  from a numpy seed) carried through ``utils/jax_weights.py`` (strict):
  both streams and ``encode`` within 1e-5 (rel-L2) in fp32, tiny3d (4 x 4 x
  16 x 16) and S3D + graph blocks at 5 and 9 (2 x 8 x 32 x 32; at 32x32
  stage 14 sees 1x1 frames, too small for a block).
* Train mode in float64 (tiny3d + its graph block, the relaxed-Bernoulli
  sampler on): each stack's graph block takes JAX's draw for that stack
  (recorded in program order, ``model_1`` then ``model_2``): both streams,
  every parameter gradient of both stacks and every BN statistic within
  1e-4.  The graph blocks' q/k kernels are scaled off the saturated softmax
  as in ``tests/_torch_resnet_util.py``.
* The state_dict keys of an S3D CMC model (graph blocks at 5, 9, 14) are
  exactly those of JAX ``export_cmc_pretrain_to_torch``, with its values,
  and load strictly.
* ``cmc_moco_forward`` / ``cmc_moco_enqueue`` and ``cmc_bank_logits`` (JAX's
  draw injected) / ``cmc_bank_update`` against JAX: logits within 1e-5, the
  queues and the pointer exact, the banks within 1e-6.
* ``create_visual_model`` raises JAX's ValueError for SimSiam under CMC;
  the two stacks hold separate weights, the first the visual model's of the
  same seed; ``create_contrast`` builds two queues or two banks.
* The two stacks draw distinct graph noise, each the draw keyed for it, and
  the key and query passes of a step share them.
* ``kernel_times.step_calls(cmc=True)``: the graph blocks and pools of JAX's
  S3D ``CmcWrapper`` (its parameters' ``jax.eval_shape``, and the calls of
  its backbone's max pool while its forward is traced) times JAX's step
  passes; and the wrapper calls
  that one port step (tiny3d) makes, counted on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import fill_variables, np_tree, rel_l2
from _torch_resnet_util import scale_embeds
from video_graph_ssl_tpu.config import cfg as jax_cfg
from video_graph_ssl_tpu.memory import bank as jbank
from video_graph_ssl_tpu.memory import moco as jmoco
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu.models import layers as jax_layers
from video_graph_ssl_tpu.models import s3d as jax_s3d
from video_graph_ssl_tpu.models import wrappers as jwrappers
from video_graph_ssl_tpu.ops import temporal_graph as jtg
from video_graph_ssl_tpu.utils.ckpt_convert import export_cmc_pretrain_to_torch
from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
from video_graph_ssl_tpu_torch.engine.pretrain import (GRAPH_STACK2_STREAM, GRAPH_STREAM,
                                                       make_pretrain_step)
from video_graph_ssl_tpu_torch.kernel_times import step_calls
from video_graph_ssl_tpu_torch.memory import bank as pbank
from video_graph_ssl_tpu_torch.memory import moco as pmoco
from video_graph_ssl_tpu_torch.memory.build import create_contrast
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.models.wrappers import CmcWrapper, temporal_diff
from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
from video_graph_ssl_tpu_torch.ops import maxpool as mp
from video_graph_ssl_tpu_torch.ops import temporal_graph as ttg
from video_graph_ssl_tpu_torch.utils.jax_weights import (load_pretrain_weights,
                                                         pretrain_state_dict)

torch.set_num_threads(1)
TINY = (4, 4, 16, 16, 3)
S3D_SHAPE = (2, 8, 32, 32, 3)


def cmc_cfg(backbone="tiny3d", mem_type="moco", dtype="float32", sampler="none",
            aug=(), feat_dim=32):
    c = jax_cfg.clone()
    c.MODEL.BACKBONE = backbone
    c.MODEL.BACKBONE_TYPE = "3D"
    c.MODEL.AUG_FLAG = True
    c.MODEL.DROPOUT = 0.0
    c.GRAPH.AUG_POINTS = tuple(aug)
    c.GRAPH.SAMPLER = sampler
    c.CROSS.MODALITY = "cross"
    c.CONTRAST.MEM_TYPE = mem_type
    c.CONTRAST.NCE_K = 16
    c.CROSS.FEAT_DIM = feat_dim
    c.TPU.COMPUTE_DTYPE = dtype
    c.TPU.PACK_POINTWISE = False
    return c


def jax_variables(c, shape, seed=0):
    """(clips, params, batch_stats) of JAX's CmcWrapper for ``c`` on clips of
    ``shape``, numpy, from ``seed``."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jmodel, _ = jax_create(c)
    shapes = jax.eval_shape(lambda v: jmodel.init(
        {"params": jax.random.key(0), "graph": jax.random.key(1)}, v), jnp.asarray(x))
    v = fill_variables(shapes, seed + 1)
    return x, v["params"], v["batch_stats"]


def port_model(c, params, stats, backbone):
    model, _ = create_visual_model(c)
    load_pretrain_weights(model, params, stats, backbone)     # strict
    return model


# --------------------------------------------------------------------------- #
# temporal_diff and the wrapper
# --------------------------------------------------------------------------- #
def test_temporal_diff_is_jax_exactly():
    x = np.random.default_rng(0).standard_normal((3, 6, 5, 4, 3)).astype(np.float32)
    ref = np.asarray(jwrappers.temporal_diff(jnp.asarray(x)))
    ours = temporal_diff(torch.from_numpy(x)).numpy()
    assert ours.shape == x.shape
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours[:, 1], x[:, 1] - x[:, 0])
    np.testing.assert_array_equal(ours[:, 0], ours[:, 1])   # front frame: the first diff


@pytest.mark.parametrize("backbone", ["tiny3d", "S3D"])
def test_cmc_wrapper_eval_matches_jax(backbone):
    s3d = backbone == "S3D"
    c = cmc_cfg(backbone, aug=(5, 9) if s3d else (), feat_dim=128 if s3d else 32)
    x, params, stats = jax_variables(c, S3D_SHAPE if s3d else TINY)
    assert set(params) == {"model_1", "model_2"}
    jmodel, feat_dim = jax_create(c)
    v = {"params": params, "batch_stats": stats}
    (f1_ref, f2_ref), enc_ref = jax.jit(lambda v, xx: (
        jmodel.apply(v, xx), jmodel.apply(v, xx, method=jmodel.encode)))(v, jnp.asarray(x))
    model = port_model(c, params, stats, backbone).eval()
    assert isinstance(model, CmcWrapper)
    with torch.no_grad():
        f1, f2 = model(torch.from_numpy(x))
        enc = model.encode(torch.from_numpy(x))
    assert f1.shape == f2.shape == (x.shape[0], int(c.CROSS.FEAT_DIM))
    assert enc.shape == (x.shape[0], feat_dim)
    for ours, ref in ((f1, f1_ref), (f2, f2_ref), (enc, enc_ref)):
        assert rel_l2(ours.numpy(), ref) < 1e-5
    # both streams L2-normalised (JAX test_cmc_model_two_encoders)
    for f in (f1, f2):
        np.testing.assert_allclose(f.norm(dim=-1).numpy(), 1.0, rtol=1e-5)


def _capture_jax_noise_in_order(monkeypatch) -> list:
    """Every relaxed-Bernoulli draw of the JAX graph blocks, in program order
    (an ordered callback: model_1's blocks, then model_2's)."""
    drawn = []
    orig = jtg.relaxed_bernoulli_sample

    def capture(key, probs, temperature, eps=1e-6):
        u = jax.random.uniform(key, probs.shape, jnp.float32, minval=eps, maxval=1.0 - eps)
        jax.debug.callback(lambda a: drawn.append(np.array(a)), u, ordered=True)
        return orig(key, probs, temperature, eps)

    monkeypatch.setattr(jtg, "relaxed_bernoulli_sample", capture)
    return drawn


def _inject_by_seed(monkeypatch, drawn: list) -> list:
    """The port's i-th distinct sampling seed takes JAX's i-th draw; returns
    the seeds in order of first use."""
    seen = []
    orig = ttg.graph_adjacency

    def inject(q, k, theta, seed=0, sample=False, u=None, **kw):
        if sample:
            if seed not in seen:
                seen.append(seed)
            u = torch.from_numpy(drawn[seen.index(seed)])
        return orig(q, k, theta, seed=seed, sample=sample, u=u, **kw)

    monkeypatch.setattr(ttg, "graph_adjacency", inject)
    return seen


def test_cmc_train_grads_and_bn_stats_match_jax(monkeypatch):
    c = cmc_cfg("tiny3d", dtype="float64", sampler="relaxed_bernoulli")
    g = np.random.default_rng(4)
    g1, g2 = g.standard_normal((2, TINY[0], 32))
    drawn = _capture_jax_noise_in_order(monkeypatch)
    with jax.enable_x64():
        x, params, stats = jax_variables(c, TINY, seed=3)
        params = np_tree(scale_embeds(params))
        jmodel, _ = jax_create(c)

        def loss(p, xx):
            (f1, f2), muts = jmodel.apply(
                {"params": p, "batch_stats": stats}, xx, train=True, mutable=["batch_stats"],
                rngs={"graph": jax.random.key(1), "dropout": jax.random.key(2)})
            return jnp.sum(f1 * g1) + jnp.sum(f2 * g2), (f1, f2, muts["batch_stats"])

        (_, (f1_ref, f2_ref, new_stats)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(params, jnp.asarray(x, jnp.float64))
        jax.effects_barrier()
        f1_ref, f2_ref = np.asarray(f1_ref), np.asarray(f2_ref)
        grads, new_stats = np_tree(grads), np_tree(new_stats)
    assert len(drawn) == 2 and not np.array_equal(drawn[0], drawn[1])

    seen = _inject_by_seed(monkeypatch, drawn)
    model = port_model(c, params, stats, "tiny3d").train()
    f1, f2 = model(torch.from_numpy(x).double(), graph_seed=(11, 12))
    ((f1 * torch.from_numpy(g1)).sum() + (f2 * torch.from_numpy(g2)).sum()).backward()
    assert len(seen) == 2      # one block per stack, each its own seed
    assert rel_l2(f1.detach().numpy(), f1_ref) < 1e-4
    assert rel_l2(f2.detach().numpy(), f2_ref) < 1e-4

    ref = pretrain_state_dict(grads, stats, "tiny3d")
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(k for k in ref if "running" not in k)
    assert {k.split(".")[0] for k in named} == {"model_1", "model_2"}
    floor = 1e-9 * max(np.linalg.norm(ref[n]) for n in named)
    for name, p in named.items():
        diff = np.linalg.norm(p.grad.numpy() - ref[name])
        assert diff < 1e-4 * max(np.linalg.norm(ref[name]), floor), name
    ref_sd = pretrain_state_dict(params, new_stats, "tiny3d")
    for name, buf in model.named_buffers():
        assert rel_l2(buf.numpy(), ref_sd[name]) < 1e-4, name


def test_state_dict_keys_are_export_cmc_pretrain_to_torch():
    c = cmc_cfg("S3D", aug=(5, 9, 14), feat_dim=128)
    _, params, stats = jax_variables(c, (1, 8, 64, 64, 3), seed=5)
    ref = export_cmc_pretrain_to_torch(params, stats)
    ours = pretrain_state_dict(params, stats, "S3D")
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    model, _ = create_visual_model(c)
    assert sorted(model.state_dict()) == sorted(ref)
    for stack in ("model_1", "model_2"):
        for idx in (5, 9, 14):
            assert f"{stack}.model.encoder.base_model.base.{idx}.0.g_q.0.weight" in ref
        assert f"{stack}.model.proj_head.head.2.weight" in ref
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in ref.items()},
                          strict=True)


# --------------------------------------------------------------------------- #
# the memories
# --------------------------------------------------------------------------- #
def _unit(g, shape):
    x = g.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_cmc_moco_forward_and_enqueue_match_jax():
    g = np.random.default_rng(6)
    b, d, K, T_ = 6, 8, 16, 0.07
    q1, k1, q2, k2 = (_unit(g, (b, d)) for _ in range(4))
    queue_1, queue_2 = _unit(g, (K, d)), _unit(g, (K, d))
    jstate = jmoco.CmcMocoState(jnp.asarray(queue_1), jnp.asarray(queue_2),
                                jnp.asarray(13, jnp.int32))
    ref = jmoco.cmc_moco_forward(jstate, *(jnp.asarray(a) for a in (q1, k1, q2, k2)), T_)
    state = pmoco.CmcMocoState(torch.from_numpy(queue_1.copy()),
                               torch.from_numpy(queue_2.copy()), 13)
    ours = pmoco.cmc_moco_forward(state, *(torch.from_numpy(a) for a in (q1, k1, q2, k2)),
                                  T_)
    for o, r in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    # logits1 is q1 against modality 2, logits2 q2 against modality 1
    np.testing.assert_allclose(ours[0][:, 1:].numpy(), q1 @ queue_2.T / T_, rtol=1e-5)
    np.testing.assert_allclose(ours[1][:, 0].numpy(), (q2 * k1).sum(-1) / T_, rtol=1e-5)
    # the enqueue wraps the ring (13 + 6 past K 16) at the one pointer
    jnext = jmoco.cmc_moco_enqueue(jstate, jnp.asarray(k1), jnp.asarray(k2))
    pmoco.cmc_moco_enqueue(state, torch.from_numpy(k1), torch.from_numpy(k2))
    assert state.ptr == int(jnext.ptr) == 3
    np.testing.assert_array_equal(state.queue_1.numpy(), np.asarray(jnext.queue_1))
    np.testing.assert_array_equal(state.queue_2.numpy(), np.asarray(jnext.queue_2))


def test_cmc_bank_logits_and_update_match_jax():
    g = np.random.default_rng(7)
    n, d, b, K, T_ = 50, 8, 6, 20, 0.07
    memory_1, memory_2 = _unit(g, (n, d)), _unit(g, (n, d))
    x1, x2 = g.standard_normal((2, b, d)).astype(np.float32)
    y = g.permutation(n)[:b]
    key = jax.random.key(3)
    jstate = jbank.CmcBankState(jnp.asarray(memory_1), jnp.asarray(memory_2))
    ref = jbank.cmc_bank_logits(jstate, jnp.asarray(x1), jnp.asarray(x2),
                                jnp.asarray(y, jnp.int32), key, K, T_)
    idx = torch.from_numpy(np.array(jax.random.randint(key, (b, K + 1), 0, n)))
    state = pbank.CmcBankState(torch.from_numpy(memory_1.copy()),
                               torch.from_numpy(memory_2.copy()))
    ours = pbank.cmc_bank_logits(state, torch.from_numpy(x1), torch.from_numpy(x2),
                                 torch.from_numpy(y), K, T_, idx=idx)
    for o, r in zip(ours[:2], ref[:2]):
        assert o.dtype == torch.float32 and o.shape == (b, K + 1)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    # one draw for both streams, slot 0 the clip's own row
    np.testing.assert_allclose(ours[0][:, 0].numpy(), (memory_2[y] * x1).sum(-1) / T_,
                               rtol=1e-5)
    np.testing.assert_allclose(ours[1][:, 0].numpy(), (memory_1[y] * x2).sum(-1) / T_,
                               rtol=1e-5)
    jnext = jbank.cmc_bank_update(jstate, jnp.asarray(x1), jnp.asarray(x2),
                                  jnp.asarray(y, jnp.int32), 0.5)
    pbank.cmc_bank_update(state, torch.from_numpy(x1), torch.from_numpy(x2),
                          torch.from_numpy(y), 0.5)
    for name in ("memory_1", "memory_2"):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(jnext, name)), rtol=1e-6, atol=1e-6)
    untouched = np.setdiff1d(np.arange(n), y)
    np.testing.assert_array_equal(state.memory_1.numpy()[untouched], memory_1[untouched])
    np.testing.assert_array_equal(state.memory_2.numpy()[untouched], memory_2[untouched])


@pytest.mark.parametrize("rows", [None, (2, 8), (6, 8)])
def test_cmc_bank_negatives_are_row_windows_of_the_global_draw(rows):
    """A rank's CMC negatives are its rows of the global batch's draw, the
    same draw for both streams."""
    n, K = 40, 5
    g = np.random.default_rng(8)
    state = pbank.CmcBankState(torch.from_numpy(_unit(g, (n, 4))),
                               torch.from_numpy(_unit(g, (n, 4))))
    full = pbank.draw_indices(torch.Generator().manual_seed(9), n, 8, K)
    b, lo = (2, rows[0]) if rows else (8, 0)
    x1, x2 = torch.ones(b, 4), torch.full((b, 4), 2.0)
    y = torch.arange(b) + 30
    l1, l2, _ = pbank.cmc_bank_logits(state, x1, x2, y, K, 1.0,
                                      generator=torch.Generator().manual_seed(9), rows=rows)
    idx = full[lo:lo + b].clone()
    idx[:, 0] = y
    torch.testing.assert_close(l1, state.memory_2[idx].sum(-1))
    torch.testing.assert_close(l2, 2.0 * state.memory_1[idx].sum(-1))


# --------------------------------------------------------------------------- #
# the builders, the graph noise, the kernel counts
# --------------------------------------------------------------------------- #
def test_create_visual_model_and_contrast_under_cmc():
    c = cmc_cfg()
    model, _ = create_visual_model(c)
    assert isinstance(model, CmcWrapper)
    assert {k.split(".")[0] for k in model.state_dict()} == {"model_1", "model_2"}
    sd = model.state_dict()
    w = "model.encoder.base_model.stage0.conv.weight"
    assert not torch.equal(sd[f"model_1.{w}"], sd[f"model_2.{w}"])
    visual = c.clone()
    visual.CROSS.MODALITY = "visual"
    for k, v in create_visual_model(visual)[0].state_dict().items():
        assert torch.equal(sd[f"model_1.{k}"], v), k
    queues = create_contrast(c)
    assert isinstance(queues, pmoco.CmcMocoState) and queues.ptr == 0
    assert queues.queue_1.shape == queues.queue_2.shape == (16, 32)
    assert not torch.equal(queues.queue_1, queues.queue_2)
    c.CONTRAST.MEM_TYPE = "bank"
    banks = create_contrast(c, n_data=24)
    assert isinstance(banks, pbank.CmcBankState)
    for m in (banks.memory_1, banks.memory_2):
        torch.testing.assert_close(m.norm(dim=1), torch.ones(24))
    state = create_pretrain_state(c, create_visual_model(c)[0], "cpu", n_data=24)
    assert state.ema_model is None
    # SimSiam under CMC: JAX's ValueError, word for word
    c.CONTRAST.MEM_TYPE = "simsiam"
    with pytest.raises(ValueError) as want:
        jax_create(c)
    with pytest.raises(ValueError) as got:
        create_visual_model(c)
    assert str(got.value) == str(want.value)


def test_cmc_stacks_draw_distinct_graph_noise(monkeypatch):
    """Flax folds each module's path into its graph key, so the two stacks'
    blocks draw different noise; the port keys ``model_2`` from its own
    stream, and the key and query passes of a step share both draws."""
    c = cmc_cfg(sampler="relaxed_bernoulli")
    calls = []
    orig = ttg.graph_adjacency

    def spy(q, k, theta, seed=0, **kw):
        adj = orig(q, k, theta, seed=seed, **kw)
        calls.append((seed, q.detach().clone(), k.detach().clone(), theta, kw, adj.detach()))
        return adj

    monkeypatch.setattr(ttg, "graph_adjacency", spy)
    model, _ = create_visual_model(c)
    state = create_pretrain_state(c, model, "cpu")
    step = make_pretrain_step(c)
    clips = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 2, 4, 16, 16, 3)).astype(np.float32))
    want = []
    for _ in range(2):
        pair = [ttg.stage_seed(state.step_seed(GRAPH_STREAM), 1),
                ttg.stage_seed(state.step_seed(GRAPH_STACK2_STREAM), 1)]
        want += pair * 2               # the key pass, then the query pass
        step(state, clips, 0.1)
    assert [s for s, *_ in calls] == want and len(set(want)) == 4
    for seed, q, k, theta, kw, adj in calls:
        again = gk.graph_adjacency_plain(q, k, theta, seed, kw["temperature"], kw["sample"],
                                         None, kw["nei_size"], kw["rows"])
        torch.testing.assert_close(adj, again, rtol=0, atol=0)
    seed1, q, k, theta, kw, adj1 = calls[0]
    other = gk.graph_adjacency_plain(q, k, theta, calls[1][0], kw["temperature"],
                                     kw["sample"], None, kw["nei_size"], kw["rows"])
    assert not torch.equal(adj1, other)


def test_step_calls_of_the_cmc_step_match_jax(monkeypatch):
    """K1 per graph block and encoder pass, K2 per block and pass plus one
    transposed call per backward, K3/K4 per pool and backward: JAX's S3D
    CmcWrapper holds 2 x 3 graph blocks (its parameters) and calls the
    backbone's max pool 2 x (9 stride-1 + 4 strided) times per forward
    (counted while ``jax.eval_shape`` traces it); its MoCo step applies the
    model twice (the EMA key pass, the query pass) and takes one gradient,
    its bank step once and one."""
    pools = {"s1": 0, "strided": 0}
    orig = jax_layers.max_pool_3d

    def counted(x, kernel_size, stride, padding=0):
        pools["s1" if stride in (1, (1, 1, 1)) else "strided"] += 1
        return orig(x, kernel_size, stride, padding)

    for module in (jax_layers, jax_s3d):
        monkeypatch.setattr(module, "max_pool_3d", counted)
    c = cmc_cfg("S3D", aug=(5, 9, 14), feat_dim=128)
    jmodel, _ = jax_create(c)
    x = jax.ShapeDtypeStruct((1, 16, 112, 112, 3), jnp.float32)
    v = jax.eval_shape(lambda xx: jmodel.init(
        {"params": jax.random.key(0), "graph": jax.random.key(1)}, xx), x)
    blocks = sum(k.startswith("graph_aug_") for stack in ("model_1", "model_2")
                 for k in v["params"][stack]["encoder"]["base_model"])
    pools.update(s1=0, strided=0)
    jax.eval_shape(lambda vv, xx: jmodel.apply(vv, xx), v, x)
    assert (blocks, pools) == (6, {"s1": 18, "strided": 8})
    for mem_type, applies in (("moco", 2), ("bank", 1)):
        want = {"graph_adjacency": blocks * applies, "gcn_propagate": blocks * (applies + 1),
                "maxpool_bwd_s1": pools["s1"], "maxpool_bwd_strided": pools["strided"],
                "sepconv_bwd": 0}
        assert step_calls(mem_type, cmc=True) == want
        visual = step_calls(mem_type)
        assert {k: 2 * n for k, n in visual.items()} == want
    assert step_calls("moco", cmc=True) == {
        "graph_adjacency": 12, "gcn_propagate": 18, "maxpool_bwd_s1": 18,
        "maxpool_bwd_strided": 8, "sepconv_bwd": 0}
    assert step_calls("moco", fused=True, cmc=True)["sepconv_bwd"] == 36
    with pytest.raises(ValueError, match="moco or bank"):
        step_calls("simsiam", cmc=True)


@pytest.mark.parametrize("mem_type", ["moco", "bank"])
def test_step_calls_count_what_one_port_step_launches(mem_type, monkeypatch):
    """One CMC step of the port (tiny3d: one graph block and one strided
    pool per stack) on the CPU, where the wrappers take their plain
    versions, counting the calls that reach them."""
    calls = {"k1": 0, "k2": 0, "k3": 0, "k4": 0}

    def counted(key, fn):
        def spy(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return spy

    plain_pool_bwd = mp.max_pool3d_bwd_plain

    def pool_bwd(x, y, dy, k, s, p):
        calls["k3" if tuple(s) == (1, 1, 1) else "k4"] += 1
        return plain_pool_bwd(x, y, dy, k, s, p)

    monkeypatch.setattr(ttg, "graph_adjacency", counted("k1", ttg.graph_adjacency))
    monkeypatch.setattr(ttg, "gcn_propagate", counted("k2", ttg.gcn_propagate))
    monkeypatch.setattr(mp, "max_pool3d_bwd_plain", pool_bwd)
    c = cmc_cfg(mem_type=mem_type)
    state = create_pretrain_state(c, create_visual_model(c)[0], "cpu", n_data=16)
    clips = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 2, 4, 16, 16, 3)).astype(np.float32))
    make_pretrain_step(c)(state, clips, 0.1, torch.arange(4))
    backwards = calls["k4"]
    assert backwards == 2       # one per stack
    want = step_calls(mem_type, backbone="tiny3d", cmc=True)
    assert want == {"graph_adjacency": calls["k1"], "gcn_propagate": calls["k2"] + backwards,
                    "maxpool_bwd_s1": calls["k3"], "maxpool_bwd_strided": calls["k4"],
                    "sepconv_bwd": 0}
