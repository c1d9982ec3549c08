#!/usr/bin/env python
"""How fast do the port and the JAX package part when both train the
graph-benefit A/B's model from one initial state?  (A diagnostic, not a
test: pytest does not collect it.)

    JAX_PLATFORMS=cpu python tests/graph_benefit_drift.py --regime simsiam --epochs 12

On the CPU, fp32, at the A/B's geometry (tiny3d, T 8, 16x16, seed 0's
``temporal_shortcut_clips``, 12 clips per class, bs 16, lr 0.3, AUG off so
that neither package draws anything): the JAX initial state is loaded into
the port, both packages' steps take the same batches in the lab's order,
and each epoch prints the last step's loss in both and their difference.
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perf import graph_benefit_lab as lab  # noqa: E402
from video_graph_ssl_tpu.data.synthetic import temporal_shortcut_clips  # noqa: E402
from video_graph_ssl_tpu.engine import create_pretrain_state as jax_state  # noqa: E402
from video_graph_ssl_tpu.engine import make_pretrain_step as jax_step  # noqa: E402
from video_graph_ssl_tpu.models import create_visual_model as jax_create  # noqa: E402
from video_graph_ssl_tpu_torch import graph_benefit as gb  # noqa: E402
from video_graph_ssl_tpu_torch.engine.build import create_pretrain_state  # noqa: E402
from video_graph_ssl_tpu_torch.engine.pretrain import make_pretrain_step  # noqa: E402
from video_graph_ssl_tpu_torch.models.build import create_visual_model  # noqa: E402
from video_graph_ssl_tpu_torch.utils.jax_weights import pretrain_state_from_jax  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--regime", default="simsiam", choices=["moco", "simsiam"])
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(1)
    t, hw, bs, lr = 8, 16, 16, 0.3
    clips, labels = temporal_shortcut_clips(per_class=12, t=t, hw=(hw, hw), seed=args.seed)
    n = len(labels)
    jcfg = lab.make_cfg(args.regime, False, t, hw)
    jcfg.MODEL.SEED = args.seed
    jmodel, _ = jax_create(jcfg)
    example = clips[:2] if args.regime == "simsiam" else clips[:2, 0]
    jstate, tx = jax_state(jcfg, jmodel, jnp.asarray(example), n_data=n)
    jstep = jax.jit(jax_step(jcfg, jmodel, tx, n_data=n))
    tree = serialization.to_state_dict(jstate)
    tree.pop("rng")

    cfg = gb.make_cfg(args.regime, False, t, hw)
    cfg.MODEL.SEED = args.seed
    model, _ = create_visual_model(cfg)
    state = create_pretrain_state(cfg, model, "cpu", n_data=n)
    pretrain_state_from_jax(jax.tree_util.tree_map(np.asarray, tree), state)
    step = make_pretrain_step(cfg)

    x, xj = torch.from_numpy(clips), jnp.asarray(clips)
    order_rng = np.random.default_rng(args.seed + 1)
    print("epoch  port loss  JAX loss  |difference|")
    for epoch in range(args.epochs):
        order = order_rng.permutation(n)
        for s in range(0, n - bs + 1, bs):
            idx = order[s:s + bs]
            ours = step(state, x[torch.from_numpy(idx)], lr, torch.from_numpy(idx))
            jstate, ref = jstep(jstate, {"clips": xj[idx], "label": jnp.zeros(bs, jnp.int32),
                                         "index": jnp.asarray(idx, jnp.int32)}, lr)
        a, b = float(ours["loss"]), float(ref["loss"])
        print(f"{epoch:5d}  {a:+.7f}  {b:+.7f}  {abs(a - b):.2e}", flush=True)


if __name__ == "__main__":
    main()
