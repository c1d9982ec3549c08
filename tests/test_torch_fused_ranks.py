"""The fused SepConv pair (``TPU.SEPCONV_FUSED``, K5's plain version on the
CPU) across ranks: two gloo ranks (``tests/_torch_dist_util.py``) each hold
half of the batch, and the pair takes its BN statistics and its backward's
BN means over the global batch.

* One pair on two ranks against one process over the global batch (its BNs
  under ``sync_bn.sum_form_bn``, the same sums in another order) and
  against JAX's ``fused_sepconv_train`` with ``jax.vjp`` on the global
  batch: output, running statistics, dx, and dWs, dWt, dgamma and dbeta
  summed over the ranks (each rank's are its own sums, which
  ``DistributedDataParallel`` averages), fp32 at 1e-5 rel-L2.
* The split of the plain backward at its two sums, in one process with an
  identity reduce: equal to the unsplit one.
* ShuffleBN's key pass (``sync_bn.per_rank_bn``, no grad) through the pair
  keeps each rank's own statistics: each rank equals one process on its
  rows alone, bit for bit.
* One rank in a group is the no-group pair, bit for bit.
* The ``MODEL.NO_PARTIALBN True TPU.SEPCONV_FUSED True`` fine-tune step of
  S3D on two ranks against one process (``sum_form_bn``).
* With a reduce, the pair sums its two BNs' statistics in the forward and
  its two pairs of BN sums in the backward, each a copy of the local ones.

Shapes: the pair at B = 4 (2 rows per rank), T = 4, 6x6, C = 5 -> F = 7
(``tests/test_fused_sepconv.py``'s); S3D at T = 8, 64x64, B = 4.  The
fused S3D MoCo step across ranks is ``tests/test_torch_fused_ranks_step.py``.
"""

import numpy as np
import torch

import _torch_dist_util as du
from _torch_port_util import rel_l2
from video_graph_ssl_tpu_torch.ops import fused_sepconv as fs
from video_graph_ssl_tpu_torch.parallel import sync_bn

torch.set_num_threads(1)
B, T, H, W, C, F = 4, 4, 6, 6, 5, 7
TOL = 1e-5
S3D_OPTS = ["MODEL.BACKBONE", "S3D", "INPUT.VIDEO_LENGTH", 8, "INPUT.SCALE_SIZE", [36, 36],
            "INPUT.BASE_SIZE", [32, 32], "INPUT.CROP_SIZE", [32, 32], "TPU.SEPCONV_FUSED",
            True, "GRAPH.AUG_POINTS", [5]]


def _inputs(seed=0):
    """JAX-layout (x, ws, wt, g1, b1, g2, b2) and a cotangent."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    x = r.standard_normal((B, T, H, W, C)).astype(f32)
    ws = (0.3 * r.standard_normal((1, 3, 3, C, F))).astype(f32)
    wt = (0.3 * r.standard_normal((3, 1, 1, F, F))).astype(f32)
    bn = [(1.0 + 0.1 * r.standard_normal(F)).astype(f32) if i % 2 == 0 else
          (0.1 * r.standard_normal(F)).astype(f32) for i in range(4)]
    gout = r.standard_normal((B, T, H, W, F)).astype(f32)
    return (x, ws, wt, *bn), gout


def _jax_pair(args, gout):
    """JAX's fused pair on the global batch: output, running statistics
    (flax momentum 0.999 from 0 and 1) and the seven gradients."""
    import jax
    import jax.numpy as jnp
    from video_graph_ssl_tpu.ops import fused_sepconv as jfs

    ja = tuple(map(jnp.asarray, args))
    (out, stats), vjp = jax.vjp(lambda *a: jfs.fused_sepconv_train(*a, jnp.float32), *ja)
    grads = vjp((jnp.asarray(gout), tuple(jnp.zeros_like(s) for s in stats)))
    mu1, var1, mu2, var2 = (np.asarray(s) for s in stats)
    running = [0.001 * mu1, 0.999 + 0.001 * var1, 0.001 * mu2, 0.999 + 0.001 * var2]
    return np.asarray(out), running, [np.asarray(g) for g in grads]


def _merge(ranks):
    """The ranks' results as one process's: rows concatenated, weight and
    BN gradients summed."""
    out = {"y": np.concatenate([r["y"] for r in ranks]),
           "dx": np.concatenate([r["dx"] for r in ranks])}
    for k in ("dws", "dwt"):
        out[k] = sum(r[k] for r in ranks)
    out["dbn"] = [sum(r["dbn"][i] for r in ranks) for i in range(4)]
    return out


def test_pair_on_two_ranks_matches_one_process_and_jax(tmp_path):
    args, gout = _inputs()
    ranks = du.run_ranks(du.fused_pair_worker, 2, tmp_path, args, gout)
    for r in ranks[1:]:   # the global statistics, on every rank alike
        for a, b in zip(r["stats"], ranks[0]["stats"]):
            np.testing.assert_array_equal(a, b)
    got = _merge(ranks)
    one = du.fused_pair_run(du._pair_layer(args), args[0], gout, sync_bn.sum_form_bn)
    out_j, running_j, grads_j = _jax_pair(args, gout)
    dx_j, dws_j, dwt_j, dg1, db1, dg2, db2 = grads_j
    for ref_name, ref in (("one process", one), ("jax", None)):
        want = ref if ref is not None else {
            "y": out_j, "dx": dx_j, "dws": dws_j, "dwt": dwt_j,
            "dbn": [dg1, db1, dg2, db2], "stats": running_j}
        assert rel_l2(got["y"], want["y"]) < TOL, ref_name
        for k in ("dx", "dws", "dwt"):
            assert rel_l2(got[k], want[k]) < TOL, (ref_name, k)
        for i, (a, b) in enumerate(zip(got["dbn"], want["dbn"])):
            assert rel_l2(a, b) < TOL, (ref_name, "dbn", i)
        for i, (a, b) in enumerate(zip(ranks[0]["stats"], want["stats"])):
            assert rel_l2(a, b) < TOL, (ref_name, "running", i)
    # per-rank statistics would be another function: the control moves the
    # output by far more than the tolerance
    control = np.concatenate([du.fused_pair_run(du._pair_layer(args), args[0][s], None)["y"]
                              for s in (slice(0, 2), slice(2, 4))])
    assert rel_l2(control, out_j) > 100 * TOL


def test_split_backward_with_identity_reduce_is_the_unsplit_one():
    args, gout = _inputs(1)
    x, ws, wt, *bn = (torch.from_numpy(np.ascontiguousarray(np.transpose(a, p)))
                      for a, p in zip(args, [(0, 4, 1, 2, 3), (4, 3, 0, 1, 2),
                                             (4, 3, 0, 1, 2)] + [(0,)] * 4))
    g = torch.from_numpy(np.ascontiguousarray(np.transpose(gout, (0, 4, 1, 2, 3))))
    out, stats, count = fs.sepconv_fwd_core(x, ws, wt, *bn, torch.float32, sync=True)
    assert count.tolist() == [float(B * T * H * W)] * F
    calls = []
    split = fs.bwd_reference(x, ws, wt, *bn, *stats, g, torch.float32, count,
                             lambda t: calls.append(t.shape))
    whole = fs.bwd_reference(x, ws, wt, *bn, *stats, g, torch.float32)
    assert calls == [(2, F), (2, F)]
    for a, b in zip(split, whole):
        assert rel_l2(a.numpy(), b.numpy()) < 1e-6


def test_shuffle_bn_key_pass_keeps_per_rank_statistics(tmp_path):
    args, _ = _inputs(2)
    ranks = du.run_ranks(du.fused_pair_worker, 2, tmp_path, args, None, True)
    for r, rows in zip(ranks, (slice(0, 2), slice(2, 4))):
        alone = du.fused_pair_run(du._pair_layer(args), args[0][rows], None)
        np.testing.assert_array_equal(r["y"], alone["y"])
        for a, b in zip(r["stats"], alone["stats"]):
            np.testing.assert_array_equal(a, b)
    assert rel_l2(ranks[0]["stats"][0], ranks[1]["stats"][0]) > 1e-3


def test_one_rank_in_a_group_is_the_no_group_pair_bit_for_bit(tmp_path):
    args, gout = _inputs(3)
    (rank,) = du.run_ranks(du.fused_pair_worker, 1, tmp_path, args, gout)
    alone = du.fused_pair_run(du._pair_layer(args), args[0], gout)
    for k in ("y", "dx", "dws", "dwt"):
        np.testing.assert_array_equal(rank[k], alone[k], err_msg=k)
    for a, b in zip(rank["dbn"] + rank["stats"], alone["dbn"] + alone["stats"]):
        np.testing.assert_array_equal(a, b)


def _update(state, init):
    return np.concatenate([(state[f"model.{k}"].astype(np.float64) - v).ravel()
                           for k, v in sorted(init.items()) if "running" not in k])


def test_no_partialbn_fused_finetune_on_two_ranks_matches_one_process(tmp_path):
    """S3D with every pair on the fused path in train mode: two ranks'
    fine-tune step against one process (its BNs in the ranks' sum form) and
    against a per-rank-statistics control, in float64 at 64x64 (the pairs
    normalise in fp32; at 32x32 the last stages' BNs see 4 values per
    channel and amplify that rounding to 3.6e-4 in the update).  Readings:
    the update 2.0e-5 from one process's, the control 2.4."""
    from video_graph_ssl_tpu_torch.models.build import create_video_model

    opts = S3D_OPTS + ["MODEL.NO_PARTIALBN", True, "DATASET.NUM_CLASS", 4,
                       "MODEL.AUG_FLAG", False, "TPU.COMPUTE_DTYPE", "float64",
                       "INPUT.BASE_SIZE", [64, 64], "INPUT.CROP_SIZE", [64, 64]]
    init = {k: v.double().numpy() for k, v in
            create_video_model(du.port_cfg(opts))[0].state_dict().items()}
    clips = np.random.default_rng(4).standard_normal((B, 8, 64, 64, 3)).astype(np.float32)
    labels = np.array([0, 3, 1, 2])
    ranks = du.run_ranks(du.ds_step_worker, 2, tmp_path, opts, None, clips, labels, (0.1,),
                         False)
    one = du.ds_step_worker(0, 1, opts, None, clips, labels, (0.1,), False,
                            bn_mode=sync_bn.sum_form_bn)
    control = du.ds_step_worker(0, 1, opts, None, clips[:2], labels[:2], (0.1,), False)
    assert all(r["ddp"] for r in ranks)
    for k, v in ranks[0]["state"].items():
        np.testing.assert_array_equal(ranks[1]["state"][k], v, err_msg=k)
    loss, ref = ranks[0]["metrics"][0]["loss"], one["metrics"][0]["loss"]
    assert abs(loss - ref) <= 1e-6 * abs(ref)
    err = rel_l2(_update(ranks[0]["state"], init), _update(one["state"], init))
    assert err < 2e-4, err
    assert rel_l2(_update(control["state"], init), _update(one["state"], init)) > 100 * 2e-4


def test_fused_pair_reduces_its_statistics_and_sums(monkeypatch):
    """With a reduce the plain backward sums two [2][F] tensors (S_g2, S_gx2
    then S_g1, S_gx1) between its sweeps, each a copy of the local sums."""
    args, gout = _inputs(5)
    one = du.fused_pair_run(du._pair_layer(args), args[0], gout, sync_bn.sum_form_bn)
    seen = []
    monkeypatch.setattr(sync_bn, "across_ranks", lambda group=None: True)
    monkeypatch.setattr(sync_bn, "all_reduce_sums",
                        lambda t, group=None: seen.append(t.clone()))
    got = du.fused_pair_run(du._pair_layer(args), args[0], gout, sync_bn.sum_form_bn)
    # forward: the two BNs' [3][F] statistics; backward: two [2][F] sums
    assert [tuple(t.shape) for t in seen] == [(3, F), (3, F), (2, F), (2, F)]
    np.testing.assert_allclose(seen[2][0].numpy(), got["dbn"][3], rtol=1e-6)
    np.testing.assert_allclose(seen[3][1].numpy(), got["dbn"][0], rtol=1e-6)
    for k in ("y", "dx", "dws", "dwt"):
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)
