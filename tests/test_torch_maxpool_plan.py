"""The launch plan of the port's max-pool backward kernel (K3/K4,
``video_graph_ssl_tpu_torch/ops/maxpool.py:bwd_plan``), on the CPU.

The kernel runs only on the card; its plan is a pure function, so the
blocking is checked here:

* the 13 pool geometries of one S3D pass (bs 128, 16x112x112) give the
  shared-memory bytes and block counts of the design table at 32-byte
  channel groups, and the plan's own (wider) groups fit two blocks per SM,
  within the 227 KB one block may take;
* for the geometries of ``tests/test_torch_maxpool.py`` (plus ragged C and
  T = 1), every input and every output is owned by exactly one block, and
  every output that covers an owned input, and every input that an owned
  output reads, lies in the same block: no block needs a halo;
* a slab above 227 KB raises.
"""

import itertools

import numpy as np
import pytest
import torch

from video_graph_ssl_tpu_torch.ops import maxpool

CASES = [
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)),    # inception block branch pool (K3)
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),    # pool_7 (K4)
    ((2, 2, 2), (2, 2, 2), (0, 0, 0)),    # pool_13 (K4)
    ((1, 3, 3), (1, 2, 2), (0, 1, 1)),    # pool_1 / pool_4 (K4)
    ((2, 2, 2), (1, 1, 1), (0, 0, 0)),    # even window, stride 1 (K3)
]
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}

_K3 = ((3, 3, 3), (1, 1, 1), (1, 1, 1))
# name: (x (B, T, H, W, C), window, stride, padding,
#        bf16 at 32-byte groups (16 channels): shared bytes, blocks,
#        the plan's choice: group bytes, bf16 shared bytes and blocks, fp32
#        shared bytes).
# Per position x (then dy) takes the group's bytes; the taps take a byte per
# output and channel.  The plan widens the group while C fills it and two
# blocks still fit on an SM.
S3D_POOLS = {
    "pool_1": ((128, 8, 56, 56, 64), (1, 3, 3), (1, 2, 2), (0, 1, 1),
               100352 + 12544, 4096, 32, 112896, 4096, 106624),
    "pool_4": ((128, 8, 28, 28, 192), (1, 3, 3), (1, 2, 2), (0, 1, 1),
               25088 + 3136, 12288, 128, 112896, 3072, 106624),
    "pool_7": ((128, 8, 14, 14, 480), (3, 3, 3), (2, 2, 2), (1, 1, 1),
               50176 + 3136, 3840, 64, 106624, 1920, 103488),
    "pool_13": ((128, 4, 7, 7, 832), (2, 2, 2), (2, 2, 2), (0, 0, 0),
                6272 + 288, 6656, 256, 52480, 896, 51328),
    "mixed_3b": ((128, 8, 14, 14, 192), *_K3, 50176 + 25088, 1536, 32, 75264, 1536, 62720),
    "mixed_3c": ((128, 8, 14, 14, 256), *_K3, 50176 + 25088, 2048, 32, 75264, 2048, 62720),
    "mixed_4b": ((128, 4, 7, 7, 480), *_K3, 6272 + 3136, 3840, 256, 75264, 512, 62720),
    "mixed_4c": ((128, 4, 7, 7, 512), *_K3, 6272 + 3136, 4096, 256, 75264, 512, 62720),
    "mixed_4d": ((128, 4, 7, 7, 512), *_K3, 6272 + 3136, 4096, 256, 75264, 512, 62720),
    "mixed_4e": ((128, 4, 7, 7, 512), *_K3, 6272 + 3136, 4096, 256, 75264, 512, 62720),
    "mixed_4f": ((128, 4, 7, 7, 528), *_K3, 6272 + 3136, 4224, 256, 75264, 640, 62720),
    "mixed_5b": ((128, 2, 3, 3, 832), *_K3, 576 + 288, 6656, 256, 6912, 896, 5760),
    "mixed_5c": ((128, 2, 3, 3, 832), *_K3, 576 + 288, 6656, 256, 6912, 896, 5760),
}


def _ncdhw_shape(bthwc):
    b, t, h, w, c = bthwc
    return (b, c, t, h, w)


@pytest.mark.parametrize("name", list(S3D_POOLS))
def test_s3d_pool_geometries_fit(name):
    shape, k, s, p, bytes32, blocks32, group_bytes, bf16_bytes, blocks, fp32_bytes = \
        S3D_POOLS[name]
    x_shape = _ncdhw_shape(shape)
    plan = maxpool.bwd_plan(x_shape, k, s, p, torch.bfloat16, group_bytes=32)
    assert (plan.smem_bytes, plan.blocks) == (bytes32, blocks32)
    for dt, want in ((torch.bfloat16, bf16_bytes), (torch.float32, fp32_bytes)):
        plan = maxpool.bwd_plan(x_shape, k, s, p, dt)
        assert plan.group * plan.element_size == group_bytes
        assert plan.smem_bytes == want <= maxpool.TWO_BLOCKS_SMEM < maxpool.MAX_SMEM_BYTES
        assert plan.slab == ("frame" if k[0] == 1 else "clip")
        assert plan.vec * plan.element_size == 16          # no ragged S3D pool
        assert 32 <= plan.threads <= maxpool.MAX_THREADS and plan.threads % 32 == 0
        if dt == torch.bfloat16:
            assert plan.blocks == blocks == plan.slabs * plan.groups


def _out_len(n, k, s, p):
    return (n + 2 * p - k) // s + 1


# the shapes of tests/test_torch_maxpool.py, ragged C and T = 1
OWNERSHIP = [(case, shape, dn) for case, shape, dn in itertools.product(
    CASES, [(2, 6, 9, 9, 8), (2, 5, 9, 9, 16), (2, 5, 9, 7, None), (2, 1, 9, 9, None)],
    DTYPES) if shape[1] + 2 * case[2][0] >= case[0][0]]


@pytest.mark.parametrize("case,shape,dn", OWNERSHIP,
                         ids=[f"{i}-{dn}" for i, (_, _, dn) in enumerate(OWNERSHIP)])
def test_every_input_and_output_in_exactly_one_block(case, shape, dn):
    k, s, p = case
    b, t, h, w, c = shape
    c = c or (12 if dn == "bf16" else 6)         # ragged: the scalar path
    plan = maxpool.bwd_plan((b, c, t, h, w), k, s, p, DTYPES[dn])
    to, ho, wo = (_out_len(n, *a) for n, a in zip((t, h, w), zip(k, s, p)))
    owned_in = np.zeros((b, c, t), np.int64)     # a block takes whole H, W
    owned_out = np.zeros((b, c, to), np.int64)
    for blk in range(plan.blocks):
        bi, (t0, t1), (o0, o1), (c0, c1) = plan.extent(blk)
        assert c1 - c0 <= plan.group and t1 - t0 == plan.t_in and o1 - o0 == plan.t_out
        owned_in[bi, c0:c1, t0:t1] += 1
        owned_out[bi, c0:c1, o0:o1] += 1
        for tt in range(t0, t1):                 # outputs that cover an owned input
            cover = [ot for ot in range(to) if ot * s[0] - p[0] <= tt < ot * s[0] - p[0] + k[0]]
            assert all(o0 <= ot < o1 for ot in cover), (blk, tt, cover)
        for ot in range(o0, o1):                 # inputs an owned output reads
            taps = [ot * s[0] - p[0] + a for a in range(k[0])]
            assert all(t0 <= tt < t1 for tt in taps if 0 <= tt < t), (blk, ot, taps)
    assert (owned_in == 1).all() and (owned_out == 1).all()
    n_in, n_out = plan.t_in * h * w, plan.t_out * ho * wo
    assert plan.smem_bytes == (max(n_in, n_out) * plan.group * plan.element_size
                               + n_out * plan.group)
    assert plan.threads >= min(maxpool.MAX_THREADS,
                               max(n_in, n_out) * plan.group // plan.vec)


@pytest.mark.parametrize("shape,k,s,p", [
    ((1, 16, 8, 112, 112), (3, 3, 3), (1, 1, 1), (1, 1, 1)),   # clip slab
    ((1, 64, 8, 112, 112), (1, 3, 3), (1, 2, 2), (0, 1, 1)),   # frame slab
])
def test_oversized_slab_raises(shape, k, s, p):
    with pytest.raises(ValueError, match="bytes of shared memory"):
        maxpool.bwd_plan(shape, k, s, p, torch.bfloat16)
