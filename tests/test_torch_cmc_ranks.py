"""The port's CMC steps across ranks, on the CPU (gloo; ranks are processes,
``tests/_torch_dist_util.py``).

Two ranks of the fused CMC step (raw uint8 clips, tiny3d + its graph block,
the relaxed-Bernoulli sampler on; augmentation, both stacks' graph noise and
the bank's negatives drawn by the port) against the port's one-process
fused step on the global batch, three steps, MoCo and bank:

* the ranks hold bit-equal states, both queues or both banks included;
* both streams' keys are gathered before the enqueue: each queue holds the
  one process's keys of the global batch in rank order, within 1e-5
  (rel-L2; the cross-rank BN of both stacks, the EMA stacks' key pass
  included, sums in another order than one process's); the pointer is the
  one process's;
* the bank's negatives of a rank are its rows of the one process's global
  draw, bit for bit, and both memories take the gathered features;
* the losses, the parameters, the BN statistics and the EMA stacks within
  1e-5 of the one process's.

Then the trainer's CLI trains CMC MoCo as two ranks in torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
gloo) for 2 steps: rank 0 alone logs and writes, and its checkpoint (both
stacks, the EMA stacks, both queues and the pointer) lies within 1e-5 of
the one-process CLI's.
"""

import glob
import socket

import numpy as np
import pytest
import torch

import _torch_dist_util as du
from _torch_port_util import rel_l2
from test_torch_ddp_step import _cli

torch.set_num_threads(1)
B, T = 4, 4
LRS = (0.1, 0.05, 0.1)
TOL = 1e-5


@pytest.mark.parametrize("mem_type", ["moco", "bank"])
def test_two_cmc_ranks_match_the_one_process_fused_step(tmp_path, mem_type):
    opts = ["CONTRAST.MEM_TYPE", mem_type]
    clips = np.random.default_rng(1).integers(0, 256, (B, 2, T, 20, 20, 3), np.uint8)
    index = np.random.default_rng(2).permutation(du.N_DATA)[:B]
    ranks = du.run_ranks(du.cmc_worker, 2, tmp_path, opts, clips, index, LRS)
    one = du.cmc_worker(0, 1, opts, clips, index, LRS)

    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
    got, ref = ranks[0], one
    for ours, want in zip(got["metrics"], ref["metrics"]):
        assert abs(ours["loss"] - want["loss"]) <= TOL * abs(want["loss"])
    st, ref_st = got["state"], ref["state"]
    assert sorted(st) == sorted(ref_st)
    memories = (("queue_1", "queue_2") if mem_type == "moco" else ("memory_1", "memory_2"))
    for name in memories:
        assert name in st
    if mem_type == "moco":
        assert int(st["ptr"]) == int(ref_st["ptr"]) == len(LRS) * B
    else:
        # each rank's negatives: its rows of the global draw, the same for
        # both streams (one draw per step)
        for r, res in enumerate(ranks):
            assert len(res["draws"]) == len(LRS)
            for part, full in zip(res["draws"], ref["draws"]):
                np.testing.assert_array_equal(part, full[r * 2:(r + 1) * 2])
        moved = ~np.all(st["memory_1"] == _fresh_bank("memory_1"), axis=1)
        np.testing.assert_array_equal(np.flatnonzero(moved), np.sort(index))
    for k, v in ref_st.items():
        if v.dtype.kind == "f":
            assert rel_l2(st[k], v) < TOL, k
        else:
            np.testing.assert_array_equal(st[k], v, err_msg=k)


def _fresh_bank(name):
    from video_graph_ssl_tpu_torch.memory.build import create_contrast

    c = du.port_cfg(["CROSS.MODALITY", "cross", "CONTRAST.MEM_TYPE", "bank"])
    return getattr(create_contrast(c, n_data=du.N_DATA), name).numpy()


def test_trainer_cli_trains_cmc_as_two_torchrun_ranks(tmp_path):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    cmc = ["CROSS.MODALITY", "cross"]
    ranks_dir, one_dir = tmp_path / "ranks", tmp_path / "one"
    ranks_dir.mkdir()
    one_dir.mkdir()
    procs = [_cli(ranks_dir, ["--dist-backend", "gloo", *cmc], RANK=str(r), LOCAL_RANK=str(r),
                  WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=port)
             for r in range(2)]
    procs.append(_cli(one_dir, cmc))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], "\n".join(o[-3000:] for o in outs)
    assert outs[0].count("Epoch: [0]") == 2 and "Epoch:" not in outs[1]
    written = glob.glob(str(ranks_dir / "run" / "**" / "*.pth.tar"), recursive=True)
    assert len(written) == 1
    (ref,) = glob.glob(str(one_dir / "run" / "**" / "checkpoint_1.pth.tar"), recursive=True)
    a, b = (torch.load(p, weights_only=True) for p in (written[0], ref))
    assert a["step"] == b["step"] == 2 and a["contrast"]["ptr"] == b["contrast"]["ptr"] == 8
    for part in ("state_dict", "model_ema"):
        assert {k.split(".")[0] for k in b[part]} == {"model_1", "model_2"}
        for k, v in b[part].items():
            assert rel_l2(a[part][k].numpy(), v.numpy()) < TOL, f"{part}.{k}"
    for q in ("queue_1", "queue_2"):
        assert rel_l2(a["contrast"][q].numpy(), b["contrast"][q].numpy()) < TOL, q
