"""The port's graph-benefit runner in lockstep with the JAX package's lab on
the CPU, fp32.

Two epochs (six steps of 16 clips) at the lab's geometry (tiny3d, T 8,
16x16, 12 clips per class of ``temporal_shortcut_clips``, seed 0, lr 0.3),
the JAX initial state carried into the port through ``run_one``'s ``init``
hook (``utils/jax_weights.pretrain_state_from_jax``): ``before`` and
``after`` (retrieval top-1 over the eval-mode encoder) equal the lab's
exactly, and ``loss_first`` / ``loss_last`` agree to ``TOL_LOSS``
relative to max(1, |loss|).

* The AUG-off arms of moco and simsiam draw nothing: the two packages run
  the same arithmetic.
* The bank (AUG off) takes JAX's negative draw of each step, injected in
  place of the port's ``bank_draw``.
* The moco graph arm takes JAX's relaxed-Bernoulli uniforms: the lab's
  jitted step hands each draw to the host (``jax.debug.callback``), and the
  port's ``graph_adjacency`` takes the draw of its step as ``u``.  Both
  passes of a step share one draw in both packages (the same step key and
  module path in JAX, the same graph seed in the port).

``TOL_LOSS``: the two packages sum in different orders, and train-mode BN
at 16 clips amplifies that only a little over six steps: the largest
difference measured here is 4.6e-6 relative (moco's ``loss_last``, graph
arm) and 3.3e-6 absolute (SimSiam's, whose loss is near 0, so it is held
relative to max(1, |loss|)).  1e-4 holds with a 20x margin in fp32, and
no case needs float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from perf import graph_benefit_lab as lab
from video_graph_ssl_tpu.data.synthetic import temporal_shortcut_clips
from video_graph_ssl_tpu.engine import create_pretrain_state as jax_state
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu.ops import temporal_graph as jtg
from video_graph_ssl_tpu_torch import graph_benefit as gb
from video_graph_ssl_tpu_torch.engine import pretrain as tpretrain
from video_graph_ssl_tpu_torch.ops import temporal_graph as ttg
from video_graph_ssl_tpu_torch.utils.jax_weights import pretrain_state_from_jax

torch.set_num_threads(1)
GEOM = dict(seed=0, epochs=2, t=8, hw=16, per_class=12, lr=0.3)
TOL_LOSS = 1e-4


def _jax_initial_state(regime: str, aug: bool):
    """The lab's initial state (the same cfg and example shapes) and its
    numpy state tree."""
    cfg = lab.make_cfg(regime, aug, GEOM["t"], GEOM["hw"])
    cfg.MODEL.SEED = GEOM["seed"]
    clips, labels = temporal_shortcut_clips(per_class=GEOM["per_class"], t=GEOM["t"],
                                            hw=(GEOM["hw"], GEOM["hw"]), seed=GEOM["seed"])
    model, _ = jax_create(cfg)
    example = jnp.asarray(clips[:2] if regime == "simsiam" else clips[:2, 0])
    state, _ = jax_state(cfg, model, example, n_data=len(labels))
    tree = serialization.to_state_dict(state)
    tree.pop("rng")     # a typed key; the port keys its streams on MODEL.SEED
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return state, tree, len(labels)


def _jax_bank_draw(state, step: int, b: int, K: int, n_data: int) -> np.ndarray:
    """JAX's negative draw of the bank step at ``step``."""
    key = jax.random.fold_in(jax.random.fold_in(state.rng, step), 7)
    return np.asarray(jax.random.randint(key, (b, K + 1), 0, n_data), np.int64)


def _capture_jax_uniforms(monkeypatch) -> dict:
    """Record every relaxed-Bernoulli uniform draw of the lab's steps, keyed
    by the draw's key (both passes of a step share one key), in order."""
    drawn = {}
    orig = jtg.relaxed_bernoulli_sample

    def record(key_data, u):
        drawn.setdefault(np.asarray(key_data).tobytes(), np.array(u))

    def capture(key, probs, temperature, eps=1e-6):
        u = jax.random.uniform(key, probs.shape, jnp.float32, minval=eps, maxval=1.0 - eps)
        data = key if key.dtype == jnp.uint32 else jax.random.key_data(key)
        jax.debug.callback(record, data, u)
        return orig(key, probs, temperature, eps)

    monkeypatch.setattr(jtg, "relaxed_bernoulli_sample", capture)
    return drawn


def _inject_uniforms(monkeypatch, draws: list) -> dict:
    """The port's graph_adjacency takes the i-th JAX draw at the i-th graph
    seed it samples with."""
    seen = {}
    orig = ttg.graph_adjacency

    def inject(q, k, theta, seed=0, sample=False, u=None, **kw):
        if sample:
            i = seen.setdefault(seed, len(seen))
            u = torch.from_numpy(draws[i]).to(q.device)
        return orig(q, k, theta, seed=seed, sample=sample, u=u, **kw)

    monkeypatch.setattr(ttg, "graph_adjacency", inject)
    return seen


def _hold(ours: dict, ref: dict) -> None:
    assert ours["before"] == ref["before"], (ours, ref)
    assert ours["after"] == ref["after"], (ours, ref)
    for k in ("loss_first", "loss_last"):
        assert abs(ours[k] - ref[k]) <= TOL_LOSS * max(1.0, abs(ref[k])), (k, ours, ref)


@pytest.mark.parametrize("regime,aug", [("moco", False), ("simsiam", False),
                                        ("bank", False), ("moco", True)])
def test_runner_matches_the_jax_lab(regime, aug, monkeypatch):
    state, tree, n = _jax_initial_state(regime, aug)
    with monkeypatch.context() as m:
        drawn = _capture_jax_uniforms(m) if aug else {}
        ref = lab.run_one(regime, aug, **GEOM)
    steps = GEOM["epochs"] * (n // 16)
    if aug:
        # one draw per step (the key pass and the query pass share it)
        assert len(drawn) == steps
        seen = _inject_uniforms(monkeypatch, list(drawn.values()))
    if regime == "bank":
        K = int(lab.make_cfg(regime, aug, GEOM["t"], GEOM["hw"]).CONTRAST.NCE_K)
        monkeypatch.setattr(tpretrain, "bank_draw", lambda st, device, n_data, b, K_, rows:
                            torch.from_numpy(_jax_bank_draw(state, st.step, b, K, n_data)))
    ours = gb.run_one(regime, aug, **GEOM, device="cpu",
                      init=lambda s: pretrain_state_from_jax(tree, s))
    if aug:
        assert len(seen) == steps
    _hold(ours, ref)
