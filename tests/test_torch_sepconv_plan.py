"""The launch plan of the port's SepConv-pair backward (K5,
``video_graph_ssl_tpu_torch/ops/sepconv_bwd.py:plan``), its products'
index maps and its cotangent rule, on the CPU.

The kernels run only on the card; what surrounds them is checked here:

* every one of the 18 fused SepConvs of an S3D pass (bs 128, 16x112x112)
  takes the tensor-core route in bf16, and fp32 or channels that are not
  multiples of 8 take the simt route;
* each product's blocks cover every output tile exactly once, its shared
  memory fits one block, no K chunk of a conv product crosses a tap, the
  weight-gradient row splits cover every row exactly once, and the fp32 and
  compute-dtype buffers hold every scratch and output, disjoint;
* the plain tap-shifted GEMMs (``tap_gemm``, ``tap_wgrad``) with the
  kernel's weight layouts and tap signs equal the convolutions and weight
  gradients of ``ops/fused_sepconv.py`` (the index maps the kernels
  mirror);
* a channel slice of a ``torch.cat`` gradient takes 16-byte loads, the
  slice the head's mean hands Mixed_5c channel-by-channel loads;
* every kernel of ``csrc/sepconv_bwd.cu`` is classed as K5 by
  ``profile_step.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from video_graph_ssl_tpu_torch import profile_step
from video_graph_ssl_tpu_torch.ops import fused_sepconv as fs
from video_graph_ssl_tpu_torch.ops import sepconv_bwd as sb

torch.set_num_threads(1)

# (B, T, H, W), (C, F) of branch 1 and of branch 2 of each Mixed block: the
# 18 fused SepConvs of one S3D pass at bs 128, 16x112x112 (chip_smoke.py)
_MIXED = {"3b": ((128, 8, 14, 14), (96, 128), (16, 32)),
          "3c": ((128, 8, 14, 14), (128, 192), (32, 96)),
          "4b": ((128, 4, 7, 7), (96, 208), (16, 48)),
          "4c": ((128, 4, 7, 7), (112, 224), (24, 64)),
          "4d": ((128, 4, 7, 7), (128, 256), (24, 64)),
          "4e": ((128, 4, 7, 7), (144, 288), (32, 64)),
          "4f": ((128, 4, 7, 7), (160, 320), (32, 128)),
          "5b": ((128, 2, 3, 3), (160, 320), (32, 128)),
          "5c": ((128, 2, 3, 3), (192, 384), (48, 128))}
S3D = {f"{blk} {br}": (*bthw, c, f) for blk, (bthw, *brs) in _MIXED.items()
       for br, (c, f) in zip(("b1", "b2"), brs)}
# small shapes: aligned (tc in bf16), ragged (simt), one row tile straddling
SMALL = {"aligned": (2, 4, 6, 6, 16, 24), "ragged": (2, 4, 6, 6, 5, 7),
         "one_frame": (3, 1, 5, 7, 8, 40)}
SHAPES = {**S3D, **SMALL}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
CASES = [(n, d) for n in SHAPES for d in DTYPES]
IDS = [f"{n}-{d}" for n, d in CASES]


def _plan(name, dn):
    return sb.plan(*SHAPES[name], DTYPES[dn])


@pytest.mark.parametrize("name", list(S3D))
def test_s3d_sepconvs_take_tc_in_bf16(name):
    assert sb.plan(*S3D[name], torch.bfloat16).route == "tc"
    assert sb.plan(*S3D[name], torch.float32).route == "simt"


@pytest.mark.parametrize("c,f", [(5, 7), (12, 16), (16, 20), (8, 8)])
def test_ragged_channels_take_simt(c, f):
    want = "tc" if c % 8 == 0 and f % 8 == 0 else "simt"
    assert sb.plan(2, 4, 6, 6, c, f, torch.bfloat16).route == want
    assert sb.plan(2, 4, 6, 6, c, f, torch.float32).route == "simt"


@pytest.mark.parametrize("name,dn", CASES, ids=IDS)
def test_blocks_cover_every_tile_once(name, dn):
    """Each product's grid, decoded as its kernel decodes blockIdx, covers
    every (row or channel, column) tile exactly once and no block is empty;
    its shared memory fits one block."""
    p = _plan(name, dn)
    tc = p.route == "tc"
    for prod in p.products:
        assert prod.smem_bytes <= sb.MAX_SMEM_BYTES
        bm, bn, _ = prod.tile
        if not prod.wgrad:
            rows_x, cols_y = prod.grid
            assert rows_x == p.mtiles and prod.threads == 256
            owned_r = np.zeros(prod.m, np.int64)
            owned_c = np.zeros(prod.n, np.int64)
            for bx in range(rows_x):
                assert bx * bm < prod.m
                owned_r[bx * bm:(bx + 1) * bm] += 1
            for by in range(cols_y):
                assert by * bn < prod.n
                owned_c[by * bn:(by + 1) * bn] += 1
            assert (owned_r == 1).all() and (owned_c == 1).all(), prod.name
            continue
        kt, nt = -(-prod.m // bm), -(-prod.n // bn)
        owned = np.zeros((prod.splits, prod.taps, prod.m, prod.n), np.int64)
        if tc:   # (taps / 3 * ktiles * ntiles, splits), tile = k fastest; 3 taps a block
            st = prod.shared_taps
            assert st == 3 and prod.taps % st == 0
            assert prod.grid == (prod.taps // st * kt * nt, prod.splits)
            blocks = [((bx // (kt * nt)) * st + u, (bx % (kt * nt)) % kt,
                       (bx % (kt * nt)) // kt, s)
                      for bx in range(prod.grid[0]) for s in range(prod.grid[1])
                      for u in range(st)]
        else:    # (ktiles, ntiles, taps * splits)
            assert prod.grid == (kt, nt, prod.taps * prod.splits) and prod.shared_taps == 1
            blocks = [(z // prod.splits, x, y, z % prod.splits) for x in range(kt)
                      for y in range(nt) for z in range(prod.grid[2])]
        for j, ki, ni, s in blocks:
            owned[s, j, ki * bm:(ki + 1) * bm, ni * bn:(ni + 1) * bn] += 1
        assert (owned == 1).all(), prod.name


@pytest.mark.parametrize("name,dn", CASES, ids=IDS)
def test_k_chunks_stay_in_one_tap(name, dn):
    """A conv product's K loop walks (tap, channel chunk) pairs: each chunk
    lies in one tap, starts on a chunk boundary, and every (tap, channel)
    is reduced exactly once; the tc chunk count is what the kernel loops
    over (taps x ceil(Cin / 32), or ceil(Cin / 16) for the spatial products,
    which run the nine taps on each staged chunk)."""
    p = _plan(name, dn)
    for prod in p.products:
        if prod.wgrad:
            continue
        bk = prod.tile[2]
        seen = np.zeros((prod.taps, prod.k), np.int64)
        chunks = list(sb.k_chunks(prod))
        for j, c0, c1 in chunks:
            assert 0 <= j < prod.taps and c0 % bk == 0 and c0 < c1 <= min(c0 + bk, prod.k)
            seen[j, c0:c1] += 1
        assert (seen == 1).all(), prod.name
        assert len(chunks) == prod.taps * -(-prod.k // bk)
        if p.route == "tc":
            assert prod.k % 8 == 0
            # spatial products stage the block's rows with W + 1 halo rows
            assert prod.halo == (p.shape[3] + 1 if prod.taps == 9 else 0)
            assert bk == (sb.TC_HALO_BK if prod.halo else sb.TC_BK)


def test_halo_rows_cover_every_tap():
    """The staged rows of a spatial tc block (its 128 rows and W + 1 on
    either side) hold every row any of its nine taps reads, and the frame
    width decides when the ring no longer fits."""
    for w in (3, 7, 14, 56):
        p = sb.plan(2, 2, 5, w, 16, 32, torch.bfloat16).product("P1 y1")
        reach = max(abs(dh * w + dw) for _, dh, dw in sb.spatial_taps(1))
        assert p.halo == w + 1 >= reach and p.smem_bytes <= sb.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        sb.plan(1, 1, 2, 2000, 16, 32, torch.bfloat16)


@pytest.mark.parametrize("name,dn", CASES, ids=IDS)
def test_wgrad_splits_cover_every_row_once(name, dn):
    p = _plan(name, dn)
    for prod in (p.product("P4 dWt"), p.product("P6 dWs")):
        rows = prod.k
        assert rows == p.rows
        seen = np.zeros(rows, np.int64)
        for s, r0, r1 in sb.k_chunks(prod):
            assert s * prod.rows_per_split <= r0 < r1 <= (s + 1) * prod.rows_per_split
            assert r1 - r0 <= prod.tile[2]
            seen[r0:r1] += 1
        assert (seen == 1).all()
        # no split is empty, and each is a whole number of chunks but the last
        assert (prod.splits - 1) * prod.rows_per_split < rows
        assert prod.rows_per_split % prod.tile[2] == 0
        if p.route == "tc":   # enough blocks for the SMs, unless the rows are few
            assert (prod.grid[0] * prod.splits >= sb.SMS
                    or prod.rows_per_split <= 2 * sb.TC_MIN_SPLIT_ROWS)


@pytest.mark.parametrize("name,dn", CASES, ids=IDS)
def test_buffers_hold_every_scratch_once(name, dn):
    """The fp32 buffer (outputs, BN constants, means, partials) and the
    compute-dtype buffer (w1..w4, y1, a, y2, dz1) hold each region at a
    16-byte aligned offset, disjoint, with the sizes the kernels write."""
    p = _plan(name, dn)
    b, t, h, w, c, f = p.shape
    p4, p6 = p.product("P4 dWt"), p.product("P6 dWs")
    want_f32 = {"dws": 9 * c * f, "dwt": 3 * f * f, "sums": 4 * f, "bn1": 4 * f,
                "bn2": 4 * f, "m1": 2 * f, "m2": 2 * f, "part": p.mtiles * 2 * f,
                "wpart": max(p4.splits * 3 * f * f, p6.splits * 9 * c * f)}
    want_act = {"w1": 9 * c * f, "w2": 3 * f * f, "w3": 3 * f * f, "w4": 9 * c * f,
                **{n: p.rows * f for n in ("y1", "a", "y2", "dz1")}}
    esize = 2 if dn == "bf16" else 4
    for names, offs, sizes, want, es in (
            (sb.F32_BUFFERS, p.f32_offsets, p.f32_sizes, want_f32, 4),
            (sb.ACT_BUFFERS, p.act_offsets, p.act_sizes, want_act, esize)):
        assert dict(zip(names, sizes)) == want
        ends = 0
        for o, s in zip(offs, sizes):
            assert o >= ends and (o * es) % 16 == 0
            ends = o + s
    assert p.f32_size == p.f32_offsets[-1] + p.f32_sizes[-1]
    fields = p.c_fields()
    assert len(fields) == len(sb.C_FIELDS)
    got = dict(zip(sb.C_FIELDS, fields))
    assert (got["B"], got["T"], got["H"], got["W"], got["C"], got["F"]) == p.shape
    assert got["splits_t"] == p4.splits and got["rps_s"] == p6.rows_per_split
    assert got["o_wpart"] == p.f32_offsets[sb.F32_BUFFERS.index("wpart")]


# --------------------------------------------------------------------------- #
def _bthwc(a: torch.Tensor) -> torch.Tensor:
    return a.permute(0, 2, 3, 4, 1)


def _ncdhw(a: torch.Tensor) -> torch.Tensor:
    return a.permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("shape", [(2, 4, 6, 6, 5, 7), (1, 3, 4, 5, 8, 16)],
                         ids=["ragged", "aligned"])
@pytest.mark.parametrize("product", ["conv_s", "conv_t", "conv_t^T", "conv_s^T",
                                     "dw_temporal", "dw_spatial"])
def test_tap_gemm_is_the_convolution(shape, product):
    """The plain tap-shifted GEMMs with the kernel's weight layouts (w1..w4)
    and tap signs against the convolutions and weight gradients of
    ``ops/fused_sepconv.py``, fp32."""
    b, t, h, w, c, f = shape
    g = torch.Generator().manual_seed(7)
    x = torch.randn(b, c, t, h, w, generator=g)
    ws = torch.randn(f, c, 1, 3, 3, generator=g)
    wt = torch.randn(f, f, 3, 1, 1, generator=g)
    a = torch.randn(b, f, t, h, w, generator=g)
    dy = torch.randn(b, f, t, h, w, generator=g)
    w1, w2, w3, w4 = sb.weight_layouts(ws, wt)
    if product == "conv_s":
        got, want = sb.tap_gemm(_bthwc(x), w1, sb.spatial_taps(1)), _bthwc(fs.conv_s(x, ws))
    elif product == "conv_t":
        got, want = sb.tap_gemm(_bthwc(a), w2, sb.temporal_taps(1)), _bthwc(fs.conv_t(a, wt))
    elif product == "conv_t^T":
        got = sb.tap_gemm(_bthwc(dy), w3, sb.temporal_taps(-1))
        want = _bthwc(F.conv_transpose3d(dy, wt, None, 1, (1, 0, 0)))
    elif product == "conv_s^T":
        got = sb.tap_gemm(_bthwc(dy), w4, sb.spatial_taps(-1))
        want = _bthwc(F.conv_transpose3d(dy, ws, None, 1, (0, 1, 1)))
    elif product == "dw_temporal":
        got = sb.wgrad_to_torch(sb.tap_wgrad(_bthwc(a), _bthwc(dy), sb.temporal_taps(1)))
        got, want = got.reshape(f, f, 3, 1, 1), fs._dw_temporal(a, dy)
    else:
        got = sb.wgrad_to_torch(sb.tap_wgrad(_bthwc(x), _bthwc(dy), sb.spatial_taps(1)))
        got, want = got.reshape(f, c, 1, 3, 3), fs._dw_spatial(x, dy)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(1.0, float(want.abs().max())))


def _branch_grads(channels, head, dims=(2, 3, 4, 5)):
    """The gradients an Inception concat hands each branch (channel slices
    of the concat's cotangent) when ``head`` follows the concat."""
    b, t, h, w = dims
    branches = [torch.randn(b, c, t, h, w).contiguous(memory_format=torch.channels_last_3d)
                .requires_grad_() for c in channels]
    seen = [None] * len(branches)
    for i, br in enumerate(branches):
        br.register_hook(lambda gr, i=i: seen.__setitem__(i, gr))
    out = torch.cat(branches, dim=1)
    assert out.is_contiguous(memory_format=torch.channels_last_3d)
    head(out).backward()
    return seen


def _next_conv(out):
    """A channels_last cotangent, as the next block's convolutions give."""
    g = torch.randn(out.shape).contiguous(memory_format=torch.channels_last_3d)
    return (out * g).sum()


def test_concat_gradient_slice_takes_vector_loads():
    """A channel slice of a channels_last_3d concat gradient is read 16
    bytes at a time where its rows allow it."""
    channels = (64, 128, 32, 32)
    total = sum(channels)
    for gr in _branch_grads(channels, _next_conv):
        assert not gr.is_contiguous(memory_format=torch.channels_last_3d)
        assert gr.stride() == (3 * 4 * 5 * total, 1, 4 * 5 * total, 5 * total, total)
        assert sb.vector_loads(gr)   # channel offsets 0, 64, 192, 224 in fp32
    odd = _branch_grads((5, 7), _next_conv)
    assert not sb.vector_loads(odd[1])   # 48-byte rows


def test_head_pool_gradient_slice_is_read_per_channel():
    """Mixed_5c's branches get channel slices of the gradient of the head's
    mean, laid out (B, T, C, H, W): read in place, channel by channel."""
    from video_graph_ssl_tpu_torch.models.s3d import head_pool

    channels = (256, 320, 128, 128)
    for gr in _branch_grads(channels, lambda y: head_pool(y).sum(), dims=(2, 2, 3, 3)):
        assert gr.stride() == (2 * 832 * 9, 9, 832 * 9, 3, 1)
        assert not sb.vector_loads(gr)


def test_vector_loads_rule():
    g = torch.randn(2, 16, 3, 4, 5)
    assert not sb.vector_loads(g)                                     # NCDHW
    cl = g.contiguous(memory_format=torch.channels_last_3d)
    assert sb.vector_loads(cl) and sb.vector_loads(cl[:, 8:16])
    assert not sb.vector_loads(cl[:, 2:10])                           # 8-byte start
    assert sb.vector_loads(torch.randn(1, 8, 1, 1, 1))
    assert not sb.vector_loads(torch.randn(2, 6, 3, 4, 5).contiguous(
        memory_format=torch.channels_last_3d))                        # 24-byte rows


def _global_names():
    csrc = Path(sb.__file__).resolve().parent.parent / "csrc"
    text = "".join(p.read_text() for p in sorted(csrc.glob("sepconv_bwd*.cu*")))
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                      text)


def test_profile_classes_every_k5_kernel():
    names = _global_names()
    assert {"sep_tc_p1_y1_kernel", "sep_tc_p6_dws_kernel", "conv_taps_kernel",
            "sep_prep_kernel", "bn_bwd_vec_kernel"} <= set(names), names
    k5 = "K5 sepconv backward"
    for n in names:
        # a demangled template instance, as the trace names it
        traced = f"void (anonymous namespace)::tc::{n}<64>((anonymous namespace)::tc::ConvArgs)"
        assert profile_step.classify(traced) == k5, n
        assert profile_step.classify(n) == k5, n
    for product in ("p1", "p2", "p3", "p4", "p5", "p6"):
        assert any(profile_step.k5_product(n) == product.upper()
                   for n in names if n.startswith("sep_tc_")), product
