"""The fused S3D GCA MoCo step (``TPU.SEPCONV_FUSED True``, the 18 branch
SepConv pairs on K5's plain version) across two gloo ranks on the CPU.

S3D + a graph block at stage 5 (sampler none, its q/k kernels scaled as in
``tests/_torch_resnet_util.py:setup``), T = 8, 32x32, B = 4 (2 rows per
rank), pre-augmented clips, three steps from JAX's initial state, in
float64 (the fused pairs normalise in fp32 in both packages, as flax's
fast-variance statistics do):

* the two ranks hold bit-equal states;
* against the port's one process over the global batch (BN in the ranks'
  sum form, ``sync_bn.sum_form_bn``) and against the JAX package's
  one-device ``make_pretrain_step``: each step's loss, the parameter update
  after step 1 and after step 3, and the keys each step put in the queue.

Tolerances.  At 32x32 the last stages' BNs normalise 4 values per channel
(1x1 frames, T = 1), so the fp32 statistics of the pairs are amplified: on
these inputs the ranks sit 7.0e-5 from one process at step 1's update and
1.9e-4 from JAX's, and up to 1e-2 by step 3, where the amplified rounding
compounds (readings beside the bounds).  Step 1 is held at about 10x its
reading, step 3 at about 5x.  A per-rank-statistics control (one process
on half of the batch) must exceed every update bound tenfold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_dist_util as du
from _torch_port_util import np_tree, rel_l2
from _torch_resnet_util import make_cfg, scale_embeds
from video_graph_ssl_tpu.engine import create_pretrain_state as jax_state
from video_graph_ssl_tpu.engine import make_pretrain_step
from video_graph_ssl_tpu.models import create_visual_model as jax_create
from video_graph_ssl_tpu_torch.models.build import create_visual_model
from video_graph_ssl_tpu_torch.parallel import sync_bn
from video_graph_ssl_tpu_torch.utils.jax_weights import (load_pretrain_weights,
                                                         pretrain_state_dict)

torch.set_num_threads(1)
B, T, S = 4, 8, 32
LRS = (0.1, 0.05, 0.1)
OPTS = ["MODEL.BACKBONE", "S3D", "TPU.SEPCONV_FUSED", True, "TPU.COMPUTE_DTYPE", "float64",
        "GRAPH.AUG_POINTS", [5], "GRAPH.SAMPLER", "none", "CONTRAST.NCE_T", 1.0]
# bounds: ranks against one process, and against JAX
# (readings: one process 4.2e-7, 7.0e-5, 8.6e-3, 4.7e-3, 6.6e-3; JAX 1.3e-6,
# 1.9e-4, 3.1e-3, 6.9e-3, 1.0e-2)
TOL_ONE = {"loss_1": 5e-6, "update_1": 7e-4, "loss_3": 5e-2, "update_3": 5e-2, "keys": 5e-2}
TOL_JAX = {"loss_1": 1e-5, "update_1": 2e-3, "loss_3": 5e-2, "update_3": 5e-2, "keys": 0.1}


def _update(st, init):
    return np.concatenate([(st[f"model.{k}"].astype(np.float64) - v).ravel()
                           for k, v in sorted(init.items()) if "running" not in k])


def _errors(got, ref, init):
    """loss_1, loss_3, update_1, update_3 and the queue's keys of ``got``
    against ``ref`` (dicts of losses, after_1 and state)."""
    return {"loss_1": abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "loss_3": abs(got["losses"][2] - ref["losses"][2]) / abs(ref["losses"][2]),
            "update_1": rel_l2(_update(got["after_1"], init), _update(ref["after_1"], init)),
            "update_3": rel_l2(_update(got["state"], init), _update(ref["state"], init)),
            "keys": rel_l2(got["state"]["queue"][:B * 3], ref["state"]["queue"][:B * 3])}


def _port(res):
    return {"losses": [m["loss"] for m in res["metrics"]], "after_1": res["after_1"],
            "state": res["state"]}


def _jax_run(c, clips):
    """JAX's initial state (the port's weights and queue) and its three
    steps: (state dict, queue, run)."""
    with jax.enable_x64():
        jmodel, _ = jax_create(c)
        state, tx = jax_state(c, jmodel, jnp.asarray(clips[:2, 0]), n_data=32)
        state = state.replace(params=scale_embeds(state.params),
                              ema_params=scale_embeds(state.ema_params))
        model, _ = create_visual_model(du.port_cfg(OPTS))
        load_pretrain_weights(model, np_tree(state.params), np_tree(state.batch_stats))
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        queue = np.array(state.contrast.queue, np.float32)
        step = jax.jit(make_pretrain_step(c, jmodel, tx))
        batch = {"clips": jnp.asarray(clips, jnp.float64), "label": jnp.zeros((B,), jnp.int32),
                 "index": jnp.arange(B, dtype=jnp.int32)}
        losses, after_1 = [], None
        for lr in LRS:
            state, m = step(state, batch, lr)
            losses.append(float(m["loss"]))
            arrays = {f"model.{k}": v for k, v in pretrain_state_dict(
                np_tree(state.params), np_tree(state.batch_stats)).items()}
            arrays["queue"] = np.asarray(state.contrast.queue)
            after_1 = after_1 or arrays
    return sd, queue, {"losses": losses, "after_1": after_1, "state": arrays}


def test_fused_s3d_moco_step_on_two_ranks_matches_one_process_and_jax(tmp_path):
    c = make_cfg("S3D", dtype="float64", aug=(5,))
    c.TPU.SEPCONV_FUSED = True
    c.CROSS.FEAT_DIM = 32
    c.CONTRAST.NCE_K = 16
    c.CONTRAST.NCE_T = 1.0
    clips = np.random.default_rng(0).standard_normal((B, 2, T, S, S, 3)).astype(np.float32)
    sd, queue, jax_run = _jax_run(c, clips)
    init = {k: v.astype(np.float64) for k, v in sd.items()}
    ranks = du.run_ranks(du.step_worker, 2, tmp_path, OPTS, sd, queue, clips, LRS, False)
    for k, v in ranks[0]["state"].items():
        np.testing.assert_array_equal(ranks[1]["state"][k], v, err_msg=k)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    one = du.step_worker(0, 1, OPTS, sd, queue, clips, LRS, False, bn_mode=sync_bn.sum_form_bn)
    got = _port(ranks[0])
    errs_one = _errors(got, _port(one), init)
    errs_jax = _errors(got, jax_run, init)
    print("ranks vs one process", errs_one, "\nranks vs jax", errs_jax)
    for k, tol in TOL_ONE.items():
        assert errs_one[k] < tol, ("one process", k, errs_one[k])
    for k, tol in TOL_JAX.items():
        assert errs_jax[k] < tol, ("jax", k, errs_jax[k])
    # control: per-rank statistics, one process on half the batch
    half = du.step_worker(0, 1, OPTS, sd, queue, clips[:2], LRS[:1], False)
    ctl = rel_l2(_update(half["after_1"], init), _update(one["after_1"], init))
    print("control", ctl)
    assert ctl > 10 * TOL_JAX["update_3"], ctl
