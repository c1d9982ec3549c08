"""``TPU.REMAT block`` across two gloo ranks (CPU): the recompute repeats the
cross-rank BN's all-reduces in the backward, on every rank in the same
order, and the two-rank MoCo step (``resnet3d_10`` + graph blocks, fp32)
equals the two-rank step without remat bit for bit, on each rank."""

import numpy as np

from _torch_dist_util import run_ranks, several_worker, step_worker

OPTS = ["MODEL.BACKBONE", "resnet3d_10", "INPUT.VIDEO_LENGTH", 16]
REMAT = ["TPU.REMAT", True, "TPU.REMAT_POLICY", "block"]
LRS = (0.1, 0.05)


def test_two_ranks_with_remat_equal_two_ranks_without(tmp_path):
    clips = np.random.default_rng(3).standard_normal((4, 2, 16, 32, 32, 3)).astype(np.float32)
    calls = [(step_worker, (OPTS + extra, None, None, clips, LRS, False))
             for extra in ([], REMAT)]
    for rank, (off, on) in enumerate(run_ranks(several_worker, 2, tmp_path, calls)):
        assert on["metrics"] == off["metrics"], rank
        assert on["state"].keys() == off["state"].keys()
        for k in off["state"]:
            np.testing.assert_array_equal(on["state"][k], off["state"][k], err_msg=f"{rank} {k}")
