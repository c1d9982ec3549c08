"""The port's SimSiam (GCA-S) and memory-bank pretrain regimes against the JAX
package on the CPU, fp32 (tiny3d + a graph block, B = 4, 4x16x16 clips).

* Lockstep: one shared initial state (the JAX init carried into the port
  through the weight bridge, the JAX bank copied), one pre-augmented batch,
  three steps of each package's ``make_pretrain_step`` with ``GRAPH.SAMPLER
  none``: SimSiam, and the bank under ``crossentropy`` and ``NCE`` with
  JAX's negative draw injected.  Loss, top-k (bank), every parameter, the
  BN statistics (the heads' included) and the bank agree to 1e-4 relative
  (rel-L2 per tensor), as ``tests/test_torch_moco_step.py`` holds MoCo.
  Everything runs in fp32 and no case needs float64.  SimSiam runs at
  B = 8: at B = 4 its train-mode BN (backbone and heads) on nearly equal
  features amplified rounding step by step past 1e-4, in fp32 and with a
  float64 backbone alike (both packages run the heads in fp32).  Six
  SimSiam tensors are zero in exact arithmetic and hold only rounding
  noise in both packages: each is held below ``ROUNDING_NOISE``
  (``ZERO_IN_EXACT_ARITHMETIC``).
* The pieces against JAX: ``bank_logits`` with JAX's injected draw and
  with a draw from ``AliasTables``, ``bank_update``, ``AliasTables.build``,
  ``nce_criterion`` with its non-finite entries in the same places (at the
  real size too), ``simsiam_d`` and its stop-gradient, SimSiam's heads.
* SimSiam's two views draw distinct graph noise, each the draw keyed for it.
* The weight carry from JAX parameters (S3D names, tiny3d values and loss),
  a JAX ``.msgpack`` resumed in the port, and the port's own checkpoint
  round trip and resume bit for bit, for both regimes.
* The trainer's entry point in both regimes on the CPU: steps, the
  checkpoint's layout, a warm start with no EMA encoder.
* The builders dispatch on ``CONTRAST.MEM_TYPE`` and, under CMC
  (``CROSS.MODALITY`` other than visual), build the two-stack model, memory
  and step (``tests/test_torch_cmc*.py`` hold them against JAX).
"""

import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_port_util import fill_variables, rel_l2
from video_graph_ssl_tpu.engine import create_pretrain_state as jax_state
from video_graph_ssl_tpu.engine import make_pretrain_step as jax_make_step
from video_graph_ssl_tpu.memory import bank as jbank
from video_graph_ssl_tpu.memory import criterion as jcrit
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu.models import heads as jheads
from video_graph_ssl_tpu.models import wrappers as jwrappers
from video_graph_ssl_tpu.utils import save_checkpoint_state as jax_save
from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state
from video_graph_ssl_tpu_torch.engine.pretrain import (GRAPH_STREAM, GRAPH_VIEW2_STREAM,
                                                       make_bank_step,
                                                       make_fused_pretrain_step,
                                                       make_pretrain_step)
from video_graph_ssl_tpu_torch.memory import bank as pbank
from video_graph_ssl_tpu_torch.memory import criterion as pcrit
from video_graph_ssl_tpu_torch.memory.build import create_contrast, create_criterion
from video_graph_ssl_tpu_torch.models import heads as pheads
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.models.wrappers import ContrastWrapper, SimSiam
from video_graph_ssl_tpu_torch.solver.build import grad_clip_norm
from video_graph_ssl_tpu_torch.utils.checkpoint import (checkpoint_payload,
                                                        load_checkpoint_state,
                                                        mismatches,
                                                        save_checkpoint_state)
from video_graph_ssl_tpu_torch.utils.jax_weights import (load_pretrain_weights,
                                                         pretrain_state_dict,
                                                         pretrain_state_from_jax)

torch.set_num_threads(1)
REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
B, T, H, W = 4, 4, 16, 16
N_DATA = 32
LRS = (0.1, 0.05, 0.1)
TOL = 1e-4
# The NCE case scores with T = 2.5 and starts each clip's bank row at its
# own initial feature: the negatives' scores are then above -m / n_data and
# the positives' above 0, so the loss stays in its domain and the lockstep
# compares finite numbers (at the shipped T = 0.07 it is NaN from step 1 in
# both packages, test_nce_criterion_matches_jax).
NCE_T = 2.5


def _cfg(tiny_cfg, mem_type, criterion="crossentropy"):
    c = tiny_cfg.clone()
    c.CONTRAST.MEM_TYPE = mem_type
    c.CROSS.CRITERION = criterion
    c.GRAPH.SAMPLER = "none"
    if criterion == "NCE":
        c.CONTRAST.NCE_T = NCE_T
    return c


# SimSiam's batch (see the module docstring)
B_SIMSIAM = 8
# SimSiam tensors that exact arithmetic keeps at their initial 0: the
# biases of the Linears that feed a BN, and projection.l3's BN bias (its
# output feeds the prediction Linear and then a BN, whose input gradient sums
# to 0 over the batch, and the loss's stop-gradient), so its batch mean is 0
# and the prediction BN's running mean with it
ZERO_IN_EXACT_ARITHMETIC = ("projection.l1.0.bias", "projection.l2.0.bias",
                            "projection.l3.0.bias", "projection.l3.1.bias",
                            "prediction.l1.0.bias", "prediction.l1.1.running_mean")
ROUNDING_NOISE = 1e-6


def _clips(seed=0, b=B):
    return np.random.default_rng(seed).standard_normal((b, 2, T, H, W, 3)).astype(np.float32)


def _batch(clips):
    b = clips.shape[0]
    return {"clips": jnp.asarray(clips), "label": jnp.zeros((b,), jnp.int32),
            "index": jnp.arange(b, dtype=jnp.int32)}


def _jax_init(c, clips):
    jmodel, _ = jax_create(c)
    example = clips[:2] if c.CONTRAST.MEM_TYPE == "simsiam" else clips[:2, 0]
    state, tx = jax_state(c, jmodel, jnp.asarray(example), n_data=N_DATA)
    return jmodel, state, tx


def _port_state(c, state):
    """The port's state at JAX's initial state (weights, BN statistics, bank)."""
    model, _ = create_visual_model(c)
    load_pretrain_weights(model, state.params, state.batch_stats, "tiny3d")
    tstate = create_pretrain_state(c, model, "cpu", n_data=N_DATA)
    if state.contrast is not None:
        tstate.contrast.memory.copy_(torch.from_numpy(np.array(state.contrast.memory)))
    return tstate


def _jax_draw(state, K, b=B):
    """JAX's negative draw of the bank step at ``state.step``."""
    key = jax.random.fold_in(jax.random.fold_in(state.rng, state.step), 7)
    return np.asarray(jax.random.randint(key, (b, K + 1), 0, N_DATA), np.int64)


def _bank_at_features(c, tstate, state, clips):
    """Both banks with rows 0..B-1 at the clips' initial features (a copy of
    the port's model in train mode, as the first step computes them)."""
    model = copy.deepcopy(tstate.model).train()
    with torch.no_grad():
        feat = model(torch.from_numpy(clips[:, 0])).numpy()
    memory = np.array(state.contrast.memory)
    memory[:len(feat)] = feat / np.linalg.norm(feat, axis=1, keepdims=True)
    tstate.contrast.memory.copy_(torch.from_numpy(memory))
    return state.replace(contrast=jbank.BankState(memory=jnp.asarray(memory)))


def assert_state_close(ours: dict, state, tol=TOL):
    """The port's model state (numpy) against the JAX state's: rel-L2 per
    tensor within ``tol``, the tensors of ``ZERO_IN_EXACT_ARITHMETIC`` at
    rounding noise in both."""
    ref = pretrain_state_dict(state.params, state.batch_stats, "tiny3d")
    assert sorted(ours) == sorted(ref)
    for k in ref:
        if k.endswith(ZERO_IN_EXACT_ARITHMETIC):
            assert max(np.abs(ours[k]).max(), np.abs(ref[k]).max()) < ROUNDING_NOISE, k
        else:
            assert rel_l2(ours[k], ref[k]) < tol, k


def _assert_state_close(tstate, state, tol=TOL):
    assert_state_close({k: v.detach().numpy() for k, v in tstate.model.state_dict().items()},
                       state, tol)
    if state.contrast is not None:
        assert rel_l2(tstate.contrast.memory.numpy(), state.contrast.memory) < tol
    assert tstate.step == int(state.step)


@pytest.mark.parametrize("mem_type,criterion", [("simsiam", "crossentropy"),
                                                ("bank", "crossentropy"),
                                                ("bank", "NCE")])
def test_step_lockstep_with_jax(tiny_cfg, mem_type, criterion):
    c = _cfg(tiny_cfg, mem_type, criterion)
    b = B_SIMSIAM if mem_type == "simsiam" else B
    clips = _clips(b=b)
    jmodel, state, tx = _jax_init(c, clips)
    jstep = jax.jit(jax_make_step(c, jmodel, tx, n_data=N_DATA))
    tstate = _port_state(c, state)
    K = int(c.CONTRAST.NCE_K)
    if mem_type == "bank":
        if criterion == "NCE":
            state = _bank_at_features(c, tstate, state, clips)
        draws = {}
        tstep = make_bank_step(K, float(c.CONTRAST.NCE_T), float(c.CONTRAST.NCE_M),
                               criterion, grad_clip_norm(c),
                               draw=lambda st, *a: torch.from_numpy(draws[st.step]))
    else:
        tstep = make_pretrain_step(c)
    heads0 = {k: v.clone() for k, v in tstate.model.state_dict().items()
              if "projection" in k or "prediction" in k}
    index = torch.arange(b)
    for lr in LRS:
        if mem_type == "bank":
            draws[tstate.step] = _jax_draw(state, K, b)
        state, jm = jstep(state, _batch(clips), lr)
        tm = tstep(tstate, torch.from_numpy(clips), lr, index)
        assert sorted(tm) == sorted(jm)
        assert np.isfinite(float(jm["loss"]))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
        for k in ("top1", "top5"):
            if k in jm:
                assert float(tm[k]) == pytest.approx(float(jm[k]))
    _assert_state_close(tstate, state)
    if mem_type == "simsiam":
        # the heads' BN statistics moved (two updates per step, one per view)
        moved = [k for k, v in heads0.items() if "running" in k
                 and not torch.equal(v, tstate.model.state_dict()[k])]
        assert len(moved) == 8
        assert tstate.ema_model is None and tstate.contrast is None


# --------------------------------------------------------------------------- #
# the pieces
# --------------------------------------------------------------------------- #
def _unit(g, shape):
    x = g.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_bank_logits_matches_jax():
    g = np.random.default_rng(1)
    n, d, b, K, T_ = 50, 8, 6, 20, 0.07
    memory, x = _unit(g, (n, d)), g.standard_normal((b, d)).astype(np.float32)
    y = g.permutation(n)[:b]
    key = jax.random.key(3)
    ref, labels = jbank.bank_logits(jbank.BankState(jnp.asarray(memory)), jnp.asarray(x),
                                    jnp.asarray(y, jnp.int32), key, K, T_)
    idx = np.asarray(jax.random.randint(key, (b, K + 1), 0, n))
    ours, tl = pbank.bank_logits(pbank.BankState(torch.from_numpy(memory)),
                                 torch.from_numpy(x), torch.from_numpy(y), K, T_,
                                 idx=torch.from_numpy(idx))
    assert ours.dtype == torch.float32 and ours.shape == (b, K + 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(labels))
    # column 0 is the positive: the clip's own row
    np.testing.assert_allclose(ours[:, 0].numpy(), (memory[y] * x).sum(-1) / T_, rtol=1e-5)


@pytest.mark.parametrize("rows", [None, (2, 8), (6, 8)])
def test_bank_draw_is_the_rows_of_the_global_draw(rows):
    """A rank's negatives are its rows of the global batch's draw, with
    slot 0 each clip's own row."""
    def draw(r):
        return pbank.draw_indices(torch.Generator().manual_seed(9), 100, 2 if r else 8, 5, r)

    full = draw(None)
    part = draw(rows)
    lo = rows[0] if rows else 0
    torch.testing.assert_close(part, full[lo:lo + part.shape[0]], rtol=0, atol=0)
    assert int(full.min()) >= 0 and int(full.max()) < 100
    bank = pbank.BankState(torch.from_numpy(_unit(np.random.default_rng(0), (100, 4))))
    y = torch.tensor([7, 3])
    logits, _ = pbank.bank_logits(bank, torch.ones(2, 4), y, 5, 1.0,
                                  generator=torch.Generator().manual_seed(9), rows=rows)
    torch.testing.assert_close(logits[:, 0], bank.memory[y].sum(-1))


def test_bank_update_matches_jax():
    g = np.random.default_rng(2)
    memory, feat = _unit(g, (40, 8)), g.standard_normal((10, 8)).astype(np.float32)
    y = g.permutation(40)[:10]
    ref = jbank.bank_update(jbank.BankState(jnp.asarray(memory)), jnp.asarray(feat),
                            jnp.asarray(y, jnp.int32), 0.5)
    state = pbank.BankState(torch.from_numpy(memory.copy()))
    pbank.bank_update(state, torch.from_numpy(feat), torch.from_numpy(y), 0.5)
    np.testing.assert_allclose(state.memory.numpy(), np.asarray(ref.memory), rtol=1e-6,
                               atol=1e-6)
    untouched = np.setdiff1d(np.arange(40), y)
    np.testing.assert_array_equal(state.memory.numpy()[untouched], memory[untouched])


def test_bank_update_rejects_repeated_rows():
    state = pbank.BankState(torch.from_numpy(_unit(np.random.default_rng(3), (10, 4))))
    with pytest.raises(RuntimeError, match="repeated rows"):
        pbank.bank_update(state, torch.ones(3, 4), torch.tensor([1, 5, 1]), 0.5)


@pytest.mark.parametrize("weights", ["uniform", "skewed", "one_hot_heavy"])
def test_alias_tables_match_jax(weights):
    g = np.random.default_rng(4)
    probs = {"uniform": np.ones(64), "skewed": g.exponential(size=37),
             "one_hot_heavy": np.r_[100.0, np.ones(15)]}[weights]
    ref = jbank.AliasTables.build(probs)
    ours = pbank.AliasTables.build(probs)
    np.testing.assert_array_equal(ours.prob.numpy(), np.asarray(ref.prob))
    np.testing.assert_array_equal(ours.alias.numpy(), np.asarray(ref.alias))
    # the torch draw follows the weights (chi-square over 200k draws)
    n = 200_000
    draws = ours.draw(torch.Generator().manual_seed(5), (n,))
    counts = np.bincount(draws.numpy(), minlength=len(probs))
    expect = probs / probs.sum() * n
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < len(probs) + 6 * np.sqrt(2 * len(probs))


@pytest.mark.parametrize("rows", [None, (2, 8)])
def test_bank_logits_draws_from_alias_tables(rows):
    """With ``alias`` the negatives follow the tables' weights (all of it
    on three rows here, where JAX's draw through its tables keeps too), a
    rank takes its rows of the global draw, and slot 0 is the clip's row."""
    n, support = 30, [3, 10, 17]
    probs = np.zeros(n)
    probs[support] = [1.0, 2.0, 3.0]
    jidx = np.asarray(jbank.AliasTables.build(probs).draw(jax.random.key(0), (8, 6)))
    assert set(jidx.ravel()) <= set(support)
    alias = pbank.AliasTables.build(probs)
    full = pbank.draw_indices(torch.Generator().manual_seed(2), n, 8, 5, None, alias)
    assert set(full.flatten().tolist()) <= set(support)
    b, lo = (2, rows[0]) if rows else (8, 0)
    part = pbank.draw_indices(torch.Generator().manual_seed(2), n, b, 5, rows, alias)
    torch.testing.assert_close(part, full[lo:lo + b], rtol=0, atol=0)
    memory = torch.from_numpy(_unit(np.random.default_rng(0), (n, 4)))
    x, y = torch.randn(b, 4, generator=torch.Generator().manual_seed(1)), torch.arange(b)
    logits, _ = pbank.bank_logits(pbank.BankState(memory), x, y, 5, 0.5,
                                  generator=torch.Generator().manual_seed(2), rows=rows,
                                  alias=alias)
    idx = part.clone()
    idx[:, 0] = y
    torch.testing.assert_close(logits, (memory[idx] * x[:, None]).sum(-1) / 0.5)


@pytest.mark.parametrize("case", ["finite", "non_finite", "real_size"])
def test_nce_criterion_matches_jax(tiny_cfg, case):
    """Row by row, so that the non-finite rows are compared in place: both
    packages give NaN or inf at the same rows and agree elsewhere.  At the
    real size (K 65536, n_data 240000, T 0.07, random unit vectors) the
    loss is non-finite in JAX and in the port."""
    g = np.random.default_rng(6)
    if case == "finite":
        x, n_data = g.uniform(0.01, 2.0, (6, 17)).astype(np.float32), 32
    elif case == "non_finite":
        x, n_data = g.uniform(-2.0, 2.0, (8, 17)).astype(np.float32), 32
    else:
        k, d = 65536, 128
        w, f = _unit(g, (2 * (k + 1), d)).reshape(2, k + 1, d), _unit(g, (2, d))
        x, n_data = np.einsum("bkd,bd->bk", w, f) / 0.07, 240000
    ref = np.array([float(jcrit.nce_criterion(jnp.asarray(x[i:i + 1]), n_data))
                    for i in range(x.shape[0])])
    ours = np.array([float(pcrit.nce_criterion(torch.from_numpy(x[i:i + 1]), n_data))
                     for i in range(x.shape[0])])
    np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(ref))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, equal_nan=True)
    whole = (float(pcrit.nce_criterion(torch.from_numpy(x), n_data)),
             float(jcrit.nce_criterion(jnp.asarray(x), n_data)))
    assert np.isfinite(whole[0]) == np.isfinite(whole[1]) == (case == "finite")
    if case == "finite":
        assert whole[0] == pytest.approx(whole[1], rel=1e-5)
    else:
        assert not np.isfinite(ref).all()
    # create_criterion gives the same function
    c = tiny_cfg.clone()
    c.CROSS.CRITERION = "NCE"
    crit = create_criterion(c, n_data)
    assert float(crit(torch.from_numpy(x[:1]))) == pytest.approx(ours[0], nan_ok=True)


def test_simsiam_d_matches_jax_and_stops_gradient():
    g = np.random.default_rng(7)
    p, z = g.standard_normal((2, 5, 16)).astype(np.float32)
    z[0] = 0.0   # a zero row: the 1e-12 clamp
    ref, (gp, gz) = jax.value_and_grad(jwrappers.simsiam_d, argnums=(0, 1))(
        jnp.asarray(p), jnp.asarray(z))
    tp = torch.from_numpy(p).requires_grad_()
    tz = torch.from_numpy(z).requires_grad_()
    ours = pcrit.simsiam_d(tp, tz)
    ours.backward()
    assert float(ours) == pytest.approx(float(ref), rel=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), rtol=1e-5, atol=1e-7)
    assert not np.asarray(gz).any() and tz.grad is None


@pytest.mark.parametrize("train", [True, False])
def test_simsiam_heads_match_jax(tiny_cfg, train):
    """ProjectionMLP and PredictionMLP with JAX's weights (carried by the
    weight bridge): outputs and, in train mode, BN statistics (flax momentum
    0.9, eps 1e-5)."""
    c = tiny_cfg.clone()
    c.CONTRAST.MEM_TYPE = "simsiam"
    hid = int(c.CROSS.FEAT_DIM)
    jmodel, feat_dim = jax_create(c)
    shapes = jax.eval_shape(lambda a: jmodel.init(
        {"params": jax.random.key(0), "graph": jax.random.key(1)}, a, train=False),
        jnp.asarray(_clips()))
    v = fill_variables(shapes, 9)
    model, _ = create_visual_model(c)
    load_pretrain_weights(model, v["params"], v["batch_stats"], "tiny3d")
    g = np.random.default_rng(8)
    for name, jmod, pmod, width in (
            ("projection", jheads.ProjectionMLP(hid, hid), model.model.projection, feat_dim),
            ("prediction", jheads.PredictionMLP(hid // 2, hid), model.model.prediction, hid)):
        x = g.standard_normal((6, width)).astype(np.float32)
        jv = {"params": v["params"]["model"][name],
              "batch_stats": v["batch_stats"]["model"][name]}
        ref, muts = jmod.apply(jv, jnp.asarray(x), train=train, mutable=["batch_stats"])
        pmod.train(train)
        ours = pmod(torch.from_numpy(x))
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        stats = {"model": {**v["batch_stats"]["model"], name: muts["batch_stats"]}}
        sd = pretrain_state_dict(v["params"], stats, "tiny3d")
        for k, a in pmod.state_dict().items():
            np.testing.assert_allclose(a.numpy(), sd[f"model.{name}.{k}"], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match=r"\(B, C\)"):
        model.model.prediction(torch.zeros(2, 3, hid))


def test_simsiam_views_draw_distinct_graph_noise(tiny_cfg, monkeypatch):
    """In JAX each graph block call draws a fresh key, so SimSiam's two
    branches get different noise; the port keys view 1 from the step's
    graph stream and view 2 from its own stream, and each branch's
    adjacency is the draw keyed for it."""
    from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
    from video_graph_ssl_tpu_torch.ops import temporal_graph as ttg

    c = tiny_cfg.clone()
    c.CONTRAST.MEM_TYPE = "simsiam"     # sampler: relaxed_bernoulli (default)
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
    clips = torch.from_numpy(_clips(4))
    want = []
    for _ in range(2):
        want += [ttg.stage_seed(state.step_seed(GRAPH_STREAM), 1),
                 ttg.stage_seed(state.step_seed(GRAPH_VIEW2_STREAM), 1)]
        step(state, clips, 0.1)
    assert [s for s, *_ in calls] == want and len(set(want)) == 4
    for seed, q, k, theta, kw, adj in calls:
        again = gk.graph_adjacency_plain(q, k, theta, seed, kw["temperature"], kw["sample"],
                                         None, kw["nei_size"], kw["rows"])
        torch.testing.assert_close(adj, again, rtol=0, atol=0)
    # the two views' noise differs: the same inputs keyed with the other
    # view's seed give another adjacency
    seed1, q, k, theta, kw, adj1 = calls[0]
    other = gk.graph_adjacency_plain(q, k, theta, calls[1][0], kw["temperature"],
                                     kw["sample"], None, kw["nei_size"], kw["rows"])
    assert not torch.equal(adj1, other)


def test_create_visual_model_dispatch(tiny_cfg):
    c = tiny_cfg.clone()
    c.CONTRAST.MEM_TYPE = "simsiam"
    model, feat_dim = create_visual_model(c)
    assert isinstance(model.model, SimSiam)
    hid = int(c.CROSS.FEAT_DIM)
    assert model.model.projection.l1[0].weight.shape == (hid, feat_dim)
    assert model.model.prediction.l1[0].weight.shape == (hid // 2, hid)
    assert model.model.prediction.l2.weight.shape == (hid, hid // 2)
    bn = model.model.projection.l3[1]
    assert (bn.momentum, bn.eps) == (pheads.HEAD_BN_MOMENTUM, pheads.HEAD_BN_EPS) == (0.9, 1e-5)
    assert create_contrast(c) is None
    c.CONTRAST.MEM_TYPE = "bank"
    model, _ = create_visual_model(c)
    assert isinstance(model.model, ContrastWrapper)
    bank = create_contrast(c, n_data=N_DATA)
    assert bank.memory.shape == (N_DATA, hid)
    torch.testing.assert_close(bank.memory.norm(dim=1), torch.ones(N_DATA))
    with pytest.raises(ValueError, match="n_data"):
        create_contrast(c)
    # CMC (any CROSS.MODALITY but visual) builds its two stacks and memories
    c.CROSS.MODALITY = "audio"
    model, _ = create_visual_model(c)
    assert {k.split(".")[0] for k in model.state_dict()} == {"model_1", "model_2"}
    banks = create_contrast(c, n_data=N_DATA)
    assert banks.memory_1.shape == banks.memory_2.shape == (N_DATA, hid)
    assert make_pretrain_step(c).__qualname__.startswith("make_cmc_bank_step")


# --------------------------------------------------------------------------- #
# weights and checkpoints
# --------------------------------------------------------------------------- #
def test_s3d_simsiam_weight_names_match_the_reference_layout(tiny_cfg):
    """JAX S3D SimSiam variables through ``pretrain_state_dict`` give the
    names and values that the JAX package's ``export_pretrain_to_torch``
    writes in the reference layout, and load strictly into the port's S3D
    SimSiam."""
    from video_graph_ssl_tpu.utils.ckpt_convert import export_pretrain_to_torch

    c = tiny_cfg.clone()
    c.MODEL.BACKBONE = "S3D"
    c.CONTRAST.MEM_TYPE = "simsiam"
    c.CROSS.FEAT_DIM = 64
    jmodel, _ = jax_create(c)
    x = jnp.zeros((1, 2, 8, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(lambda a: jmodel.init(
        {"params": jax.random.key(0), "graph": jax.random.key(1)}, a, train=False), x)
    v = fill_variables(shapes, 10)
    ref = export_pretrain_to_torch(v["params"], v["batch_stats"], "simsiam")
    ours = pretrain_state_dict(v["params"], v["batch_stats"], "S3D")
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    model, _ = create_visual_model(c)
    load_pretrain_weights(model, v["params"], v["batch_stats"], "S3D")
    assert any(k.startswith("model.projection.l3.1.") for k in model.state_dict())


def test_tiny3d_simsiam_weight_carry_gives_jax_loss(tiny_cfg):
    """Random JAX parameters carried into the port: the eval-mode loss of
    both views agrees."""
    c = tiny_cfg.clone()
    c.CONTRAST.MEM_TYPE = "simsiam"
    jmodel, _ = jax_create(c)
    clips = _clips(11)
    shapes = jax.eval_shape(lambda a: jmodel.init(
        {"params": jax.random.key(0), "graph": jax.random.key(1)}, a, train=False),
        jnp.asarray(clips))
    v = fill_variables(shapes, 12)
    ref = float(jmodel.apply(v, jnp.asarray(clips), train=False))
    model, _ = create_visual_model(c)
    load_pretrain_weights(model, v["params"], v["batch_stats"], "tiny3d")
    model.eval()
    with torch.no_grad():
        ours = float(model(torch.from_numpy(clips), graph_seed=(0, 1)))
    assert ours == pytest.approx(ref, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("mem_type", ["simsiam", "bank"])
def test_jax_checkpoint_resumes_in_the_port(tiny_cfg, tmp_path, mem_type):
    """JAX trains 2 steps and writes its ``.msgpack``; the port reads it
    with ``pretrain_state_from_jax`` and its step 3 lands on JAX's."""
    c = _cfg(tiny_cfg, mem_type)
    b = B_SIMSIAM if mem_type == "simsiam" else B
    clips = _clips(12, b)
    jmodel, state, tx = _jax_init(c, clips)
    jstep = jax.jit(jax_make_step(c, jmodel, tx, n_data=N_DATA))
    K = int(c.CONTRAST.NCE_K)
    for lr in (0.1, 0.05):
        state, _ = jstep(state, _batch(clips), lr)
    path = str(tmp_path / "jax.msgpack")
    jax_save(path, state, epoch=1)
    with open(path, "rb") as f:
        tree = serialization.msgpack_restore(f.read())["state"]

    model, _ = create_visual_model(c, seed=5)
    tstate = create_pretrain_state(c, model, "cpu", n_data=N_DATA)
    pretrain_state_from_jax(tree, tstate)
    assert tstate.step == 2
    if mem_type == "bank":
        draw = _jax_draw(state, K)
        tstep = make_bank_step(K, float(c.CONTRAST.NCE_T), float(c.CONTRAST.NCE_M),
                               "crossentropy", grad_clip_norm(c),
                               draw=lambda *a: torch.from_numpy(draw))
    else:
        tstep = make_pretrain_step(c)
    state, jm = jstep(state, _batch(clips), 0.1)
    tm = tstep(tstate, torch.from_numpy(clips), 0.1, torch.arange(b))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
    _assert_state_close(tstate, state)


def _raw(n, seed=0):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.integers(0, 256, (B, 2, T, 20, 20, 3), dtype=np.uint8))
            for _ in range(n)]


def _fresh(c, seed=None):
    model, _ = create_visual_model(c, seed=seed)
    return create_pretrain_state(c, model, "cpu", n_data=N_DATA)


@pytest.mark.parametrize("mem_type", ["simsiam", "bank"])
def test_checkpoint_round_trip_and_resume_bit_for_bit(tiny_cfg, tmp_path, mem_type):
    """The fused step with its augmentation, graph and negative draws: 4
    steps straight == 2 steps, checkpoint, restore into a fresh state
    (other weights, other bank), 2 steps; the checkpoint holds the bank's
    rows as ``contrast.memory`` and no EMA, or neither for SimSiam."""
    c = tiny_cfg.clone()
    c.CONTRAST.MEM_TYPE = mem_type
    batches = _raw(4, seed=1)
    index = [torch.arange(B) + B * (i % 2) for i in range(4)]
    lrs = (0.1, 0.1, 0.05, 0.05)
    step = make_fused_pretrain_step(c)
    straight = _fresh(c)
    for clips, idx, lr in zip(batches, index, lrs):
        last = step(straight, clips, lr, idx)

    first = _fresh(c)
    for clips, idx, lr in zip(batches[:2], index[:2], lrs[:2]):
        step(first, clips, lr, idx)
    path = str(tmp_path / "mid.pth.tar")
    save_checkpoint_state(path, first, epoch=1)
    payload = torch.load(path, weights_only=True)
    assert "model_ema" not in payload
    if mem_type == "bank":
        assert set(payload["contrast"]) == {"memory"}
        assert payload["contrast"]["memory"].shape == (N_DATA, int(c.CROSS.FEAT_DIM))
    else:
        assert "contrast" not in payload
    resumed = _fresh(c, seed=7)
    assert mismatches(checkpoint_payload(first, 1), checkpoint_payload(resumed, 1))
    load_checkpoint_state(path, resumed)
    assert mismatches(checkpoint_payload(first, 1), checkpoint_payload(resumed, 1)) == []
    for clips, idx, lr in zip(batches[2:], index[2:], lrs[2:]):
        again = step(resumed, clips, lr, idx)
    assert torch.equal(last["loss"], again["loss"])
    assert mismatches(checkpoint_payload(straight, 2), checkpoint_payload(resumed, 2)) == []
    # a checkpoint of another regime does not load
    other = tiny_cfg.clone()
    other.CONTRAST.MEM_TYPE = "moco"
    with pytest.raises(KeyError, match="CONTRAST.MEM_TYPE"):
        load_checkpoint_state(path, _fresh(other))


TRAIN = ["MODEL.BACKBONE", "tiny3d", "MODEL.AUG_FLAG", "True", "DATASET.NUM_CLASS", "4",
         "DATALOADER.BATCH_SIZE", "4", "DATALOADER.NUM_WORKERS", "2",
         "INPUT.VIDEO_LENGTH", "4", "INPUT.SCALE_SIZE", "[20, 20]",
         "INPUT.BASE_SIZE", "[16, 16]", "CONTRAST.NCE_K", "8", "CROSS.FEAT_DIM", "32",
         "CHECKPOINT.PRINT_FREQ", "1", "DATASET.SOURCE", "synthetic",
         "SOLVER.MAX_EPOCHS", "1", "TPU.COMPUTE_DTYPE", "float32"]


@pytest.mark.parametrize("mem_type", ["simsiam", "bank"])
def test_trainer_cli_trains_each_regime(tmp_path, monkeypatch, capsys, mem_type):
    """The entry point in either regime: 2 steps (the bank takes each batch's
    dataset indices, a bank of NUM_CLASS x 4 rows), a checkpoint in the
    regime's layout, then a warm start from it (no EMA encoder to fill)."""
    import glob

    from video_graph_ssl_tpu_torch import train_video_contrast_dis as train

    config = str(REPO_ROOT / "configs" / "visual_moco.yaml")
    monkeypatch.chdir(tmp_path)
    opts = TRAIN + ["CONTRAST.MEM_TYPE", mem_type]
    train.main(["--config_file", config, "--device", "cpu", "--max_steps", "2", *opts])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("Epoch: [0]")]
    assert len(lines) == 2 and "Loss" in lines[0]
    if mem_type == "simsiam":   # SimSiam reports its loss only
        assert all("Prec@1 0.000 (0.000)" in ln for ln in lines)
    (path,) = glob.glob(str(tmp_path / "run" / "**" / "checkpoint_1.pth.tar"), recursive=True)
    payload = torch.load(path, weights_only=True)
    assert payload["step"] == 2 and "model_ema" not in payload
    if mem_type == "bank":
        assert payload["contrast"]["memory"].shape == (16, 32)
    else:
        assert "contrast" not in payload
        assert "model.projection.l1.1.running_var" in payload["state_dict"]
    c = train.load_config(config, opts + ["MODEL.PRETRAINED", "True",
                                          "MODEL.PRETRAIN_PATH", path])
    trainer = train.Trainer(c, device="cpu", run_dir=str(tmp_path / "warm"))
    got = trainer.state.model.model.encoder.base_model.state_dict()
    for k, v in got.items():
        assert torch.equal(v, payload["state_dict"][f"model.encoder.base_model.{k}"]), k
