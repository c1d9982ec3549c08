"""The launch plan of the port's max-pool backward kernel (K3/K4,
``video_graph_ssl_tpu_torch/ops/maxpool.py:bwd_plan``), on the CPU.

The kernel runs only on the card; its plan is a pure function, so the
blocking is checked here:

* the 13 pool geometries of one S3D pass (bs 128, 16x112x112) give the
  shared-memory bytes and block counts of the design table at 32-byte
  channel groups, and the plan's own (wider) groups fit two blocks per SM,
  within the 227 KB one block may take, each slab in one block;
* the same 13 pools at 16x224x224, 32x112x112 and 32x224x224 plan without
  raising: slabs above 227 KB are cut into strips of dx rows;
* for the geometries of ``tests/test_torch_maxpool.py`` (plus ragged C and
  T = 1) and for strip plans, every dx element is owned by exactly one
  block, every output whose window covers an owned input is staged in that
  block, and every input a staged output reads is staged (the halo);
* a plain-PyTorch emulation of a strip plan (each block's halo'd extent
  through the plain version, its owned dx rows kept) equals the plain
  version on the whole tensor bit for bit;
* only a W too wide for a strip of one row with its halo raises;
* TF "SAME" padding (I3D's pools, a high pad one more than the low): the
  plan's output extents are JAX's (``nn.max_pool(padding="SAME")``'s
  ``eval_shape``) at every I3D pool of the 16x112x112 and 16x224x224
  steps, and the port's forward gives them; ownership holds at ragged
  SAME shapes, and the strip emulation equals the plain version bit for
  bit at SAME strip plans (the stem pool's frame strips at 224x224, pool_7
  strips along T and H with odd and even extents).
"""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
        assert (plan.t_strips, plan.h_strips) == (1, 1)     # a slab per block
        assert plan.vec * plan.element_size == 16          # no ragged S3D pool
        assert 32 <= plan.threads <= maxpool.MAX_THREADS and plan.threads % 32 == 0
        if dt == torch.bfloat16:
            assert plan.blocks == blocks == plan.slabs * plan.groups


# frame sizes of the S3D pools' inputs at 112x112 and at 224x224 (pool_13
# rounds 7 down to 3 at 112x112, 14 to 7 at 224x224)
HW = {112: {56: 56, 28: 28, 14: 14, 7: 7, 3: 3},
      224: {56: 112, 28: 56, 14: 28, 7: 14, 3: 7}}


def _scaled(shape, frames, size):
    """An S3D pool's x at another clip length and frame size (T scales with
    the clip length: every stride in t is 1 or 2 on even lengths)."""
    b, t, h, w, c = shape
    return (b, t * frames // 16, HW[size][h], HW[size][w], c)


# the pools that need strips there: (geometry, pool) -> (frames, rows) a
# bf16 block owns; every other pool keeps one slab per block
STRIPPED = {("16x224", "pool_1"): (1, 24), ("16x224", "mixed_3b"): (8, 7),
            ("16x224", "mixed_3c"): (8, 7), ("32x224", "pool_1"): (1, 24),
            ("32x224", "pool_7"): (16, 4), ("32x224", "mixed_3b"): (16, 2),
            ("32x224", "mixed_3c"): (16, 2)}
GEOMETRIES = {"16x224": (16, 224), "32x112": (32, 112), "32x224": (32, 224)}


@pytest.mark.parametrize("geom", list(GEOMETRIES))
@pytest.mark.parametrize("name", list(S3D_POOLS))
def test_s3d_pools_plan_at_224_and_32_frames(name, geom):
    shape, k, s, p = S3D_POOLS[name][:4]
    shape = _scaled(shape, *GEOMETRIES[geom])
    for dt in (torch.bfloat16, torch.float32):
        plan = maxpool.bwd_plan(_ncdhw_shape(shape), k, s, p, dt)
        assert plan.smem_bytes <= maxpool.MAX_SMEM_BYTES
        strips = (plan.t_strip, plan.h_strip) if plan.t_strips * plan.h_strips > 1 else None
        if dt == torch.bfloat16:
            assert strips == STRIPPED.get((geom, name)), (strips, plan)
        if strips:      # narrowest groups, two blocks per SM
            assert plan.group * plan.element_size == 32
            assert plan.smem_bytes <= maxpool.TWO_BLOCKS_SMEM
        # one batch element suffices for ownership: blocks repeat per slab
        _check_ownership(maxpool.bwd_plan(_ncdhw_shape((1,) + shape[1:]), k, s, p, dt),
                         shape[1:4], k, s, p)


def _check_ownership(plan, thw, k, s, padding):
    """Every dx element owned by one block; the outputs covering its owned
    inputs and the inputs those outputs read lie in its staged ranges, and
    the ranges fit the plan's shared layout (``padding`` in any form the
    port takes)."""
    t, h, w = thw
    pads = maxpool.resolve_padding(padding, thw, k, s)
    p = tuple(lo for lo, _ in pads)
    to, ho, wo = maxpool.out_sizes(thw, k, s, pads)
    b, c = plan.slabs // (t if plan.slab == "frame" else 1), plan.channels
    owned = np.zeros((b, c, t, h), np.int64)     # a block takes whole W
    staged_out = np.zeros((b, c, to, ho), np.int64)
    for blk in range(plan.blocks):
        e = plan.block(blk)
        (c0, c1), (t0, t1), (h0, h1) = e.chans, e.own_t, e.own_h
        assert c1 - c0 <= plan.group
        owned[e.b, c0:c1, t0:t1, h0:h1] += 1
        staged_out[e.b, c0:c1, e.out_t[0]:e.out_t[1], e.out_h[0]:e.out_h[1]] += 1
        if plan.slab == "clip":
            assert e.x_t[1] - e.x_t[0] <= plan.x_frames
            assert e.out_t[1] - e.out_t[0] <= plan.y_frames
        assert e.x_h[1] - e.x_h[0] <= plan.x_rows and e.out_h[1] - e.out_h[0] <= plan.y_rows
        for axis, (a0, a1), (o0, o1), (x0, x1) in ((0, e.own_t, e.out_t, e.x_t),
                                                   (1, e.own_h, e.out_h, e.x_h)):
            if axis == 0 and plan.slab == "frame":
                continue
            n, n_out = thw[axis], (to, ho)[axis]
            ka, sa, pa = k[axis], s[axis], p[axis]
            for a in range(a0, a1):          # outputs that cover an owned input
                cover = [o for o in range(n_out) if o * sa - pa <= a < o * sa - pa + ka]
                assert all(o0 <= o < o1 for o in cover), (blk, axis, a, cover)
            for o in range(o0, o1):          # inputs a staged output reads
                taps = [o * sa - pa + i for i in range(ka)]
                assert all(x0 <= i < x1 for i in taps if 0 <= i < n), (blk, axis, o)
    assert (owned == 1).all()
    if plan.t_strips * plan.h_strips == 1:   # a slab per block: outputs once too
        assert (staged_out == 1).all()
    else:
        assert (staged_out >= 1).all()


# the shapes of tests/test_torch_maxpool.py, ragged C and T = 1; then strip
# plans: a 224x224-like stem frame and Mixed_3b clip with shrunk channels,
# and clips cut along T too
OWNERSHIP = [(case, shape, dn) for case, shape, dn in itertools.product(
    CASES, [(2, 6, 9, 9, 8), (2, 5, 9, 9, 16), (2, 5, 9, 7, None), (2, 1, 9, 9, None)],
    DTYPES) if shape[1] + 2 * case[2][0] >= case[0][0]] + [
    (case, shape, dn) for case, shape in (
        (CASES[3], (1, 2, 112, 112, 16)), (CASES[0], (1, 8, 28, 28, 16)),
        (CASES[0], (1, 16, 6, 80, 16)), (CASES[1], (1, 16, 7, 80, 16)),
        (CASES[2], (2, 5, 9, 300, 16))) for dn in DTYPES]


# TF "SAME" (I3D): the strided geometries at odd and even extents (high
# pads one more than the low, and equal), ragged C; a strip plan of each
SAME_CASES = [((1, 3, 3), (1, 2, 2), "SAME"), ((3, 3, 3), (2, 2, 2), "SAME"),
              ((2, 2, 2), (2, 2, 2), "SAME")]
OWNERSHIP += [(case, shape, dn) for case, shape, dn in itertools.product(
    SAME_CASES, [(2, 6, 10, 10, 8), (2, 5, 9, 7, None), (2, 4, 7, 8, 16)], DTYPES)] + [
    (SAME_CASES[0], (1, 2, 112, 112, 16), dn) for dn in DTYPES] + [
    (SAME_CASES[1], (1, 16, 7, 80, 16), dn) for dn in DTYPES]


@pytest.mark.parametrize("case,shape,dn", OWNERSHIP,
                         ids=[f"{i}-{dn}" for i, (_, _, dn) in enumerate(OWNERSHIP)])
def test_every_input_and_output_in_exactly_one_block(case, shape, dn):
    k, s, p = case
    b, t, h, w, c = shape
    c = c or (12 if dn == "bf16" else 6)         # ragged: the scalar path
    plan = maxpool.bwd_plan((b, c, t, h, w), k, s, p, DTYPES[dn])
    _check_ownership(plan, (t, h, w), k, s, p)
    pads = maxpool.resolve_padding(p, (t, h, w), k, s)
    to, ho, wo = maxpool.out_sizes((t, h, w), k, s, pads)
    assert plan.rows_out == ho
    n_x, n_y = plan.x_frames * plan.x_rows * w, plan.y_frames * plan.y_rows * wo
    assert plan.smem_bytes == (max(n_x, n_y) * plan.group * plan.element_size
                               + n_y * plan.group)
    assert plan.threads >= min(maxpool.MAX_THREADS, max(n_x, n_y) * plan.group // plan.vec)
    if plan.t_strips * plan.h_strips == 1:
        assert (plan.x_frames, plan.x_rows, plan.y_rows) == (plan.t_in, h, ho)
        assert plan.y_frames == (1 if plan.slab == "frame" else to)


def emulate_plan(plan, x, y, dy, k, s, padding):
    """dx by the plan's blocks in plain PyTorch: each block's staged x (its
    rows of the padding as -inf) and staged y, dy through
    ``max_pool3d_bwd_plain``; only the block's owned dx rows are kept."""
    pairs = maxpool.resolve_padding(padding, x.shape[2:], k, s)
    p = tuple(lo for lo, _ in pairs)
    dx = torch.full_like(x, float("nan"))
    for i in range(0, plan.blocks, plan.groups):   # channels: all at once
        e = plan.block(i)
        (ot0, ot1), (oh0, oh1) = e.out_t, e.out_h
        (t0, t1), (h0, h1) = e.own_t, e.own_h
        dx[e.b, :, t0:t1, h0:h1] = 0.0
        if ot1 == ot0 or oh1 == oh0:
            continue
        pads, start = [], []
        for (o0, o1), (x0, x1), ka, sa, pa in ((e.out_t, e.x_t, k[0], s[0], p[0]),
                                               (e.out_h, e.x_h, k[1], s[1], p[1])):
            first, end = o0 * sa - pa, (o1 - 1) * sa - pa + ka
            assert x0 >= first and end >= x1       # never more than the windows
            pads = [x0 - first, end - x1] + pads
            start.append(first)
        xs = F.pad(x[e.b:e.b + 1, :, e.x_t[0]:e.x_t[1], e.x_h[0]:e.x_h[1]],
                   (0, 0, *pads), value=float("-inf"))
        sub = (slice(e.b, e.b + 1), slice(None), slice(ot0, ot1), slice(oh0, oh1))
        d = maxpool.max_pool3d_bwd_plain(xs, y[sub], dy[sub], k, s, (0, 0, pairs[2]))[0]
        lt0, lh0 = t0 - start[0], h0 - start[1]
        # owned rows that no staged window reads keep dx = 0
        a0, a1 = max(lt0, 0), min(lt0 + t1 - t0, d.shape[1])
        b0, b1 = max(lh0, 0), min(lh0 + h1 - h0, d.shape[2])
        dx[e.b, :, a0 + t0 - lt0:a1 + t0 - lt0, b0 + h0 - lh0:b1 + h0 - lh0] = \
            d[:, a0:a1, b0:b1]
    return dx


# (window, stride, padding), x (B, T, H, W, C) with 224x224 proportions and
# shrunk channels: the stem's frame strips, Mixed_3b's clip strips, clip
# strips along T and H (stride 1 and 2), and strips with ragged last rows
EMULATED = {"stem_224_frame_strips": (CASES[3], (1, 2, 112, 112, 16)),
            "mixed_3b_224_clip_strips": (CASES[0], (2, 8, 28, 28, 16)),
            "s1_t_and_h_strips": (CASES[0], (1, 16, 6, 80, 16)),
            "pool7_t_and_h_strips": (CASES[1], (1, 16, 7, 80, 16)),
            "pool13_ragged_strips": (CASES[2], (2, 5, 9, 300, 16)),
            # TF "SAME": I3D's stem pool at 224x224, H and W (0, 1); pool_7
            # with T (0, 1), H (1, 1) and W (0, 1)
            "i3d_stem_224_same_frame_strips": (SAME_CASES[0], (1, 2, 112, 112, 16)),
            "i3d_pool7_same_t_and_h_strips": (SAME_CASES[1], (1, 16, 7, 80, 16))}


@pytest.mark.parametrize("dn", list(DTYPES))
@pytest.mark.parametrize("name", list(EMULATED))
def test_strip_plan_emulation_equals_plain(name, dn):
    (k, s, p), (b, t, h, w, c) = EMULATED[name]
    dt = DTYPES[dn]
    plan = maxpool.bwd_plan((b, c, t, h, w), k, s, p, dt)
    assert plan.t_strips * plan.h_strips > 1
    g = torch.Generator().manual_seed(3)
    x = torch.randn((b, c, t, h, w), generator=g).to(dt)
    y = maxpool.pool_forward(x, k, s, maxpool.resolve_padding(p, (t, h, w), k, s))
    dy = torch.randn(y.shape, generator=g).to(dt)
    want = maxpool.max_pool3d_bwd_plain(x, y, dy, k, s, p)
    got = emulate_plan(plan, x, y, dy, k, s, p)
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("shape,k,s,p", [
    ((1, 16, 8, 112, 112), (3, 3, 3), (1, 1, 1), (1, 1, 1)),   # clip slab
    ((1, 64, 8, 112, 112), (1, 3, 3), (1, 2, 2), (0, 1, 1)),   # frame slab
    ((1, 16, 8, 8, 247), (3, 3, 3), (1, 1, 1), (1, 1, 1)),     # W too wide
])
def test_oversized_slab_raises(shape, k, s, p):
    """A slab above 227 KB no longer raises: it is cut into strips.  Only a
    W too wide for a strip of one input row with its halo still raises
    (246 is the widest for this geometry in bf16)."""
    if shape[-1] > 246:
        with pytest.raises(ValueError, match="a strip of one input row"):
            maxpool.bwd_plan(shape, k, s, p, torch.bfloat16)
        maxpool.bwd_plan(shape[:-1] + (246,), k, s, p, torch.bfloat16)
        return
    plan = maxpool.bwd_plan(shape, k, s, p, torch.bfloat16)
    assert plan.t_strips * plan.h_strips > 1
    assert plan.smem_bytes <= maxpool.TWO_BLOCKS_SMEM


@pytest.mark.parametrize("size,batch", [(112, 128), (224, 32)])
def test_same_plan_outputs_equal_jax(size, batch):
    """At every I3D pool of the step, the plan's output extents (and the
    port's forward's) are those of JAX's "SAME" pool."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn
    from video_graph_ssl_tpu_torch.kernel_times import geometry

    for name, kn, (b, t, h, w, c), k, s, pads in geometry(size, batch, "I3D")[2]:
        want = jax.eval_shape(lambda v: nn.max_pool(v, k, s, padding="SAME"),
                              jax.ShapeDtypeStruct((b, t, h, w, c), jnp.bfloat16)).shape
        assert pads == maxpool.same_padding((t, h, w), k, s)
        for dt in (torch.bfloat16, torch.float32):
            plan = maxpool.bwd_plan((b, c, t, h, w), k, s, "SAME", dt)
            assert plan.rows_out == want[2], name
            assert plan.t_out == (1 if plan.slab == "frame" else want[1]), name
            assert plan == maxpool.bwd_plan((b, c, t, h, w), k, s, pads, dt)
        assert maxpool.out_sizes((t, h, w), k, s, pads) == tuple(want[1:4]), name
        y = maxpool.pool_forward(torch.zeros(1, 1, t, h, w), k, s, pads)
        assert tuple(y.shape[2:]) == tuple(want[1:4]), name
