"""3D max pooling with hand-written kernels for the forward and for the
backward (K3 and K4).

Counterpart of ``video_graph_ssl_tpu/ops/pallas/maxpool_kernel.py``.  The
forward, on a CUDA tensor, is one launch of ``csrc/maxpool_fwd.cu``
through the operator ``vgs_torch::max_pool3d_fwd`` (so ``torch.export``
keeps it in an exported graph): a block per strip of one slab's y and
channel group stages the x its windows read in shared memory and writes y
once; no indices, no scratch, no padded copy.  It saves x and y for the
backward, not indices.  :func:`fwd_plan` is its launch plan, a pure
function.  The backward, on a CUDA tensor, is one launch of
``csrc/maxpool_bwd.cu``: a block per slab (a whole clip, or one frame when
the window and stride are 1 in t) and channel group stages the slab's x in
shared memory, finds each output's first maximal tap there, then stages dy
in the same space and gathers dx; device memory sees x, y and dy read once
and dx written once, and no scratch.  A slab above the 227 KB one block may
take (stage 1's pool and Mixed_3b/3c's at 224x224) is cut into strips of
dx rows, along H and where needed along T; each block stages, with a halo,
the outputs whose windows cover its rows and the x those windows read, and
writes its own dx rows only, so the halo rows' x, y and dy are read by two
blocks.  :func:`bwd_plan` is that launch's plan.  On a CPU tensor the
forward runs :func:`pool_forward` (the library's ``F.max_pool3d``) and the
backward :func:`max_pool3d_bwd_plain`, the plain PyTorch versions that the
tests and ``chip_smoke.py`` hold the kernels to.  There is no fallback
from a kernel to the library or the plain version.

The one limit left is W.  Backward: a strip of one input row of one frame,
with its halo, must fit one block.  The widest W that plans (32-byte
channel groups; bf16 / fp32): 1,320 / 1,383 for the (1,3,3)/(1,2,2) pools,
279 / 284 for (3,3,3)/(2,2,2), 1,709 / 1,761 for (2,2,2)/(2,2,2) and 246 /
266 for the stride-1 (3,3,3) pools: at least 8x the W of the S3D pools of
each geometry at 224x224 (112 and 56, 28, 14, and 28 at Mixed_3b/3c).
Forward: the x one output row of one output frame reads must fit one
block, which it does up to W 2,421 for (1,3,3)/(1,2,2), 807 for the 3x3x3
pools and 1,816 for (2,2,2)/(2,2,2), in either dtype.

The forward's values are PyTorch's bit for bit: a tap replaces the running
maximum where it is greater or NaN, in t, h, w scan order, so a window
holding a NaN gives NaN and a tie keeps the first maximum.  Backward ties
go to the first maximal tap in t, h, w scan order, PyTorch's rule.  Both
backward versions add the contributions to one input in increasing output
order, as PyTorch's CPU backward does, so in fp32 they agree with it bit
for bit.

Padding is PyTorch's symmetric one (an int or one per axis), a
``(lo, hi)`` pair per axis, or ``"SAME"``, resolved per input as JAX's
``lax.padtype_to_pads`` resolves it (:func:`same_padding`; I3D's pools).
The kernels take the low pads and the true output extents, and clip every
window at the input's ends, so a high-side pad needs nothing more of them.
The CPU forward is ``F.max_pool3d`` with ``padding=lo``, with
``ceil_mode`` where the high side is one larger (:func:`ceil_mode_matches`:
the same windows, no copy), else on an input padded with -inf.

Tensors are ``(B, C, T, H, W)``; the kernels take them in
``torch.channels_last_3d`` memory, the backbone's layout.

The forward runs under a ``maxpool_fwd`` span and the backward (the dy cast
and copy, dx's allocation and the launch, or the plain version) under a
``maxpool_bwd`` span (``utils/tracing.py``).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import NamedTuple, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import _build

MAX_WINDOW = 3
MAX_SMEM_BYTES = 232448   # 227 KB, the most shared memory one block may take
MAX_THREADS = 512         # the kernel's __launch_bounds__
# Channels per block, in bytes of one position: 32 (a DRAM sector) to 256.
# On the H100 a wider group (longer runs of each position read at once)
# helped at the S3D pools while two blocks still fit on an SM, and mostly
# hurt beyond.
GROUP_BYTES = (32, 64, 128, 256)
TWO_BLOCKS_SMEM = 115712  # the most shared memory a block may take with two per SM
FWD_SMEM = 57344          # the forward's: four blocks per SM, so loads overlap the max
FWD_THREADS = 256         # csrc/maxpool_fwd.cu's __launch_bounds__
# The forward's time per staged byte at each group width, relative to 32
# bytes: measured on the H100 at the S3D pools of the bs-256 step, where a
# wider group outran the halo rows it adds (read again mostly from L2).
FWD_WIDTH_COST = {32: 1.0, 64: 0.86, 128: 0.70, 256: 0.64}
_CL = torch.channels_last_3d


Pads = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]
Padding = Union[int, str, Sequence]


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        assert len(v) == 3
        return tuple(int(i) for i in v)
    return (int(v),) * 3


def same_padding(sizes, kernel_size, stride) -> Pads:
    """TF "SAME" padding of each axis (JAX ``lax.padtype_to_pads``): the
    output is ceil(n / s), the total pad max((out - 1) s + k - n, 0), of
    which the low side takes half, rounded down."""
    pads = []
    for n, k, s in zip(sizes, _triple(kernel_size), _triple(stride)):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def resolve_padding(padding: Padding, sizes, kernel_size, stride) -> Pads:
    """``(lo, hi)`` per axis of ``padding``: an int or one per axis
    (symmetric), a ``(lo, hi)`` pair per axis, or ``"SAME"`` (for input
    extents ``sizes``)."""
    if isinstance(padding, str):
        if padding.upper() != "SAME":
            raise ValueError(f"padding {padding!r}: an int, (lo, hi) pairs or 'SAME'")
        return same_padding(sizes, kernel_size, stride)
    if not isinstance(padding, (tuple, list)):
        padding = (padding,) * 3
    if len(padding) != 3:
        raise ValueError(f"padding {padding!r}: one entry per axis (T, H, W)")
    return tuple((int(p[0]), int(p[1])) if isinstance(p, (tuple, list))
                 else (int(p), int(p)) for p in padding)


def out_sizes(sizes, k, s, pads: Pads) -> Tuple[int, int, int]:
    """Output extents of a pool over ``sizes`` with ``(lo, hi)`` pads."""
    return tuple((n + lo + hi - ki) // si + 1
                 for n, ki, si, (lo, hi) in zip(sizes, k, s, pads))


def ceil_mode_matches(sizes, k, s, pads: Pads) -> bool:
    """Whether ``F.max_pool3d(padding=lo, ceil_mode=True)`` has the windows
    of the ``(lo, hi)`` pads: the same starts o s - lo, so it does where
    its output count (PyTorch's rule, pooling_shape.h) is the same and
    each lo is at most half the window."""
    for n, ki, si, (lo, hi) in zip(sizes, k, s, pads):
        o = -(-(n + 2 * lo - ki) // si) + 1
        if (o - 1) * si >= n + lo:
            o -= 1
        if lo > ki // 2 or o != (n + lo + hi - ki) // si + 1:
            return False
    return True


def pool_forward(x: torch.Tensor, k, s, pads: Pads, return_indices: bool = False):
    """The max pool's forward with ``(lo, hi)`` pads, through the library's
    ``F.max_pool3d``: symmetric pads directly, a high side one larger with
    ``ceil_mode`` where :func:`ceil_mode_matches`, else on a copy of x
    padded with -inf (indices then index the padded input)."""
    lo = tuple(p[0] for p in pads)
    if all(a == b for a, b in pads):
        return F.max_pool3d(x, k, s, lo, return_indices=return_indices)
    if ceil_mode_matches(x.shape[2:], k, s, pads):
        return F.max_pool3d(x, k, s, lo, ceil_mode=True, return_indices=return_indices)
    flat = (*pads[2], *pads[1], *pads[0])
    return F.max_pool3d(F.pad(x, flat, value=float("-inf")), k, s, 0,
                        return_indices=return_indices)


class Block(NamedTuple):
    """What one block of a backward launch works on (global coordinates of
    its slab's clip; ranges are half-open).  It writes dx at ``own_t`` x
    ``own_h`` (all W) alone; it stages y, dy and the taps of the outputs
    ``out_t`` x ``out_h`` (all Wo): every output whose window covers an
    owned input; and it stages x at ``x_t`` x ``x_h`` (all W): every input
    those outputs' windows read."""
    b: int
    chans: Tuple[int, int]
    own_t: Tuple[int, int]
    own_h: Tuple[int, int]
    out_t: Tuple[int, int]
    out_h: Tuple[int, int]
    x_t: Tuple[int, int]
    x_h: Tuple[int, int]


def axis_cover(a0: int, a1: int, k: int, s: int, p: int, n_in: int,
               n_out: int) -> Tuple[int, int, int, int]:
    """For owned inputs [a0, a1) of one axis: the outputs [o0, o1) whose
    window covers one of them, and the inputs [x0, x1) those windows read
    (padding excluded).  ``csrc/maxpool_bwd.cu:axis_cover`` is the same
    arithmetic."""
    n = a0 + p - k + 1
    o0 = 0 if n <= 0 else -(-n // s)
    o1 = min(n_out, (a1 - 1 + p) // s + 1)
    if o1 <= o0:
        return o0, o0, 0, 0
    return o0, o1, max(0, o0 * s - p), min(n_in, (o1 - 1) * s - p + k)


def _axis_layout(n_in: int, n_out: int, strip: int, k: int, s: int, p: int):
    """(strips, most inputs a strip stages, most outputs it stages) along
    one axis; one strip stages the whole axis."""
    strips = -(-n_in // strip)
    if strips == 1:
        return 1, n_in, n_out
    covers = [axis_cover(a, min(n_in, a + strip), k, s, p, n_in, n_out)
              for a in range(0, n_in, strip)]
    return (strips, max(x1 - x0 for _, _, x0, x1 in covers),
            max(o1 - o0 for o0, o1, _, _ in covers))


class BwdPlan(NamedTuple):
    """How one backward call is cut into blocks (``csrc/maxpool_bwd.cu``)."""
    slab: str         # "clip" (T, H, W) or "frame" (H, W)
    slabs: int        # B for clips, B * T for frames
    t_in: int         # frames of x in a slab
    t_out: int        # frames of y in a slab
    rows_out: int     # rows of y (Ho)
    group: int        # channels per block (the last group is masked at C)
    groups: int
    element_size: int
    vec: int          # channels per thread vector: 16 bytes, or 1 for ragged C
    threads: int
    blocks: int
    smem_bytes: int   # x (then dy) as [position][group], taps as [output][group] bytes
    channels: int     # the call's C, T and H
    frames: int
    rows: int
    # strips: each block owns t_strip frames and h_strip rows of its slab's
    # dx (one strip of each = the whole slab, the plan of slabs that fit)
    t_strip: int
    h_strip: int
    t_strips: int
    h_strips: int
    # the shared-memory layout, the most any block stages: x as
    # [x_frames][x_rows][W], y, dy and taps as [y_frames][y_rows][Wo]
    x_frames: int
    x_rows: int
    y_frames: int
    y_rows: int
    geometry: Tuple[Tuple[int, int, int], ...]   # window, stride, low pads

    def block(self, i: int) -> Block:
        """Block ``i``, in the kernel's order: the channel group fastest,
        then the H strip, the T strip, the slab."""
        rest, g = divmod(i, self.groups)
        rest, hi = divmod(rest, self.h_strips)
        slab, ti = divmod(rest, self.t_strips)
        c0 = g * self.group
        chans = (c0, min(c0 + self.group, self.channels))
        (kt, kh, _), (st, sh, _), (pt, ph, _) = self.geometry
        h0 = hi * self.h_strip
        h1 = min(self.rows, h0 + self.h_strip)
        oh0, oh1, xh0, xh1 = axis_cover(h0, h1, kh, sh, ph, self.rows, self.rows_out)
        if self.slab == "frame":
            b, t = divmod(slab, self.frames)
            return Block(b, chans, (t, t + 1), (h0, h1), (t, t + 1), (oh0, oh1),
                         (t, t + 1), (xh0, xh1))
        t0 = ti * self.t_strip
        t1 = min(self.t_in, t0 + self.t_strip)
        ot0, ot1, xt0, xt1 = axis_cover(t0, t1, kt, st, pt, self.t_in, self.t_out)
        return Block(slab, chans, (t0, t1), (h0, h1), (ot0, ot1), (oh0, oh1),
                     (xt0, xt1), (xh0, xh1))


@functools.lru_cache(maxsize=256)
def _cached_plan(x_shape, k, s, pads, dtype) -> BwdPlan:
    return bwd_plan(x_shape, k, s, pads, dtype)


def bwd_plan(x_shape, kernel_size, stride, padding, dtype,
             group_bytes: int | None = None) -> BwdPlan:
    """The launch of one backward call for x of ``x_shape`` (B, C, T, H, W)
    and ``padding`` in any form :func:`resolve_padding` takes; the output
    extents are the forward's (:func:`out_sizes`).

    Where a whole slab fits one block (227 KB of shared memory at the
    narrowest group), one block per (slab, channel group); the group is the
    widest of ``GROUP_BYTES`` that C fills and that leaves room for two
    blocks per SM (the narrowest where none does), unless ``group_bytes`` is
    given.  Otherwise the slab is cut into strips of dx rows (frame slabs
    along H; clip slabs along H, and along T where one row of every frame
    does not fit), 32-byte groups unless given: the tallest strip (of the
    most frames) that fits two blocks per SM, else one.  Raises
    ``ValueError`` where even a strip of one input row of one frame, with
    its halo, exceeds what one block may take."""
    k, s = _triple(kernel_size), _triple(stride)
    b, c, t, h, w = (int(v) for v in x_shape)
    pads = resolve_padding(padding, (t, h, w), k, s)
    p = tuple(lo for lo, _ in pads)
    to, ho, wo = out_sizes((t, h, w), k, s, pads)
    esize = dtype.itemsize
    frame = k[0] == 1 and s[0] == 1 and pads[0] == (0, 0)
    slabs, t_in, t_out = (b * t, 1, 1) if frame else (b, t, to)
    vec = 16 // esize if c % (16 // esize) == 0 else 1

    def layout(ts, hs):
        nts, nxt, nyt = _axis_layout(t_in, t_out, ts, k[0], s[0], p[0])
        nhs, nxh, nyh = _axis_layout(h, ho, hs, k[1], s[1], p[1])
        return (nts, nhs), (nxt, nxh, nyt, nyh)

    def smem_of(nbytes, lay):
        nxt, nxh, nyt, nyh = lay
        n_x, n_y = nxt * nxh * w, nyt * nyh * wo
        return max(n_x, n_y) * nbytes + n_y * (nbytes // esize)

    whole = layout(t_in, h)[1]
    fixed = group_bytes is not None
    if not fixed:
        fits = [gb for gb in GROUP_BYTES if gb == GROUP_BYTES[0]
                or (gb // esize <= c and smem_of(gb, whole) <= TWO_BLOCKS_SMEM)]
        group_bytes = fits[-1]
    strip = (t_in, h)
    if smem_of(group_bytes, whole) > MAX_SMEM_BYTES:
        group_bytes = group_bytes if fixed else GROUP_BYTES[0]
        strip = _strip(t_in, h, lambda ts, hs: smem_of(group_bytes, layout(ts, hs)[1]))
        if strip is None:
            raise ValueError(
                f"max_pool3d backward: x {tuple(x_shape)}, window {k}, stride {s}: "
                f"a strip of one input row of one frame with its halo needs "
                f"{smem_of(group_bytes, layout(1, 1)[1])} bytes of shared memory "
                f"per block, above the {MAX_SMEM_BYTES} one block may take "
                f"(see the module docstring for the widest W that fits)")
    (nts, nhs), lay = layout(*strip)
    smem, group = smem_of(group_bytes, lay), group_bytes // esize
    groups = -(-c // group)
    n_pos = max(lay[0] * lay[1] * w, lay[2] * lay[3] * wo)
    # whole warps, and a whole number of positions (group // vec threads each)
    unit = max(32, group // vec)
    threads = min(MAX_THREADS, -(-n_pos * (group // vec) // unit) * unit)
    return BwdPlan("frame" if frame else "clip", slabs, t_in, t_out, ho, group, groups,
                   esize, vec, threads, slabs * nts * nhs * groups, smem, c, t, h,
                   strip[0], strip[1], nts, nhs, *lay, (k, s, p))


def _strip(t_in: int, h: int, smem_of):
    """(frames, rows) of the strips: for the first budget (two blocks per
    SM, then one) and the most frames (all first) where some strip fits,
    the most rows that fit; None where no strip of one row fits."""
    for budget in (TWO_BLOCKS_SMEM, MAX_SMEM_BYTES):
        for ts in range(t_in, 0, -1):
            hs = next((r for r in range(h, 0, -1) if smem_of(ts, r) <= budget), 0)
            if hs:
                return ts, hs
    return None


class FwdBlock(NamedTuple):
    """What one block of a forward launch works on (global coordinates of
    its slab's clip; ranges are half-open).  It writes y at ``out_t`` x
    ``out_h`` (all Wo) alone, and stages x at ``x_t`` x ``x_h`` (all W):
    every input those outputs' windows read."""
    b: int
    chans: Tuple[int, int]
    out_t: Tuple[int, int]
    out_h: Tuple[int, int]
    x_t: Tuple[int, int]
    x_h: Tuple[int, int]


def axis_reads(o0: int, o1: int, k: int, s: int, p: int, n_in: int) -> Tuple[int, int]:
    """The inputs [x0, x1) that the windows of outputs [o0, o1) of one axis
    read (padding excluded).  ``csrc/maxpool_fwd.cu:axis_reads`` is the same
    arithmetic."""
    return max(0, o0 * s - p), min(n_in, (o1 - 1) * s - p + k)


class FwdPlan(NamedTuple):
    """How one forward call is cut into blocks (``csrc/maxpool_fwd.cu``)."""
    slab: str         # "clip" (T, H, W) or "frame" (H, W)
    slabs: int        # B for clips, B * T for frames
    t_in: int         # frames of x in a slab
    t_out: int        # frames of y in a slab
    rows_out: int     # rows of y (Ho)
    group: int        # channels per block (the last group is masked at C)
    groups: int
    element_size: int
    vec: int          # channels per thread vector: 16 bytes, or 1 for ragged C
    threads: int
    blocks: int
    smem_bytes: int   # x as [x_frames][x_rows][W][group]
    channels: int     # the call's C, T and H
    frames: int
    rows: int
    # strips: each block writes t_strip frames and h_strip rows of its
    # slab's y (one strip of each = the whole slab)
    t_strip: int
    h_strip: int
    t_strips: int
    h_strips: int
    x_frames: int     # the most frames and rows of x any block stages
    x_rows: int
    geometry: Tuple[Tuple[int, int, int], ...]   # window, stride, low pads

    def block(self, i: int) -> FwdBlock:
        """Block ``i``, in the kernel's order: the channel group fastest,
        then the H strip, the T strip, the slab."""
        rest, g = divmod(i, self.groups)
        rest, hi = divmod(rest, self.h_strips)
        slab, ti = divmod(rest, self.t_strips)
        c0 = g * self.group
        chans = (c0, min(c0 + self.group, self.channels))
        (kt, kh, _), (st, sh, _), (pt, ph, _) = self.geometry
        oh = (hi * self.h_strip, min(self.rows_out, (hi + 1) * self.h_strip))
        xh = axis_reads(*oh, kh, sh, ph, self.rows)
        if self.slab == "frame":
            b, t = divmod(slab, self.frames)
            return FwdBlock(b, chans, (t, t + 1), oh, (t, t + 1), xh)
        ot = (ti * self.t_strip, min(self.t_out, (ti + 1) * self.t_strip))
        return FwdBlock(slab, chans, ot, oh, axis_reads(*ot, kt, st, pt, self.t_in), xh)


def _axis_reads(n_in: int, n_out: int, strip: int, k: int, s: int, p: int):
    """(strips, most inputs a strip reads, inputs read by all strips) along
    one axis cut into strips of ``strip`` outputs."""
    reads = [axis_reads(o, min(n_out, o + strip), k, s, p, n_in)
             for o in range(0, n_out, strip)]
    return len(reads), max(x1 - x0 for x0, x1 in reads), sum(x1 - x0 for x0, x1 in reads)


def fwd_plan(x_shape, kernel_size, stride, padding, dtype) -> FwdPlan:
    """The launch of one forward call for x of ``x_shape`` (B, C, T, H, W)
    and ``padding`` in any form :func:`resolve_padding` takes.

    A block per (slab, strip of y, channel group): it stages the x its
    outputs' windows read, so a strip's halo rows are read by two blocks.
    For each channel group of ``GROUP_BYTES`` that C fills, the strips are
    those whose x fits ``FWD_SMEM`` (four blocks per SM) and that read the
    fewest inputs in all: for each number of output frames the most rows
    that fit, the most frames of equals.  The group is the one of least
    cost, the widest of equals: the inputs its strips read, over the share
    of its channels that C fills, times its ``FWD_WIDTH_COST``.  Where no
    strip fits, the narrowest group with strips within what one block may
    take; raises ``ValueError`` where even one output row of one output
    frame exceeds it."""
    k, s = _triple(kernel_size), _triple(stride)
    b, c, t, h, w = (int(v) for v in x_shape)
    pads = resolve_padding(padding, (t, h, w), k, s)
    p = tuple(lo for lo, _ in pads)
    to, ho, wo = out_sizes((t, h, w), k, s, pads)
    esize = dtype.itemsize
    frame = k[0] == 1 and s[0] == 1 and pads[0] == (0, 0)
    slabs, t_in, t_out = (b * t, 1, 1) if frame else (b, t, to)
    vec = 16 // esize if c % (16 // esize) == 0 else 1

    def layout(ts, hs):
        nts, nxt, sum_t = _axis_reads(t_in, t_out, ts, k[0], s[0], p[0])
        nhs, nxh, sum_h = _axis_reads(h, ho, hs, k[1], s[1], p[1])
        return (nts, nhs), (nxt, nxh), sum_t * sum_h

    def strip(gb, budget):
        fits = []
        for ts in range(t_out, 0, -1):
            hs = next((r for r in range(ho, 0, -1)
                       if math.prod(layout(ts, r)[1]) * w * gb <= budget), 0)
            if hs:
                fits.append((layout(ts, hs)[2], -ts, hs))
        if not fits:
            return None
        _, ts, hs = min(fits)
        return -ts, hs

    def cost(gb, st):
        # staged bytes over the live ones: the halo, and the masked
        # channels of a ragged last group
        live = c / (-(-c // (gb // esize)) * (gb // esize))
        return layout(*st)[2] * FWD_WIDTH_COST[gb] / live

    widths = [gb for gb in GROUP_BYTES if gb == GROUP_BYTES[0] or gb // esize <= c]
    best = None
    for gb in widths:
        st = strip(gb, FWD_SMEM)
        if st is not None and (best is None or cost(gb, st) <= best[2]):
            best = (gb, st, cost(gb, st))
    if best is None:
        gb = widths[0]
        st = strip(gb, MAX_SMEM_BYTES)
        if st is None:
            raise ValueError(
                f"max_pool3d forward: x {tuple(x_shape)}, window {k}, stride {s}: a strip "
                f"of one output row of one output frame reads "
                f"{math.prod(layout(1, 1)[1]) * w * gb} bytes of x per block, above the "
                f"{MAX_SMEM_BYTES} one block may take (see the module docstring for the "
                f"widest W that fits)")
        best = (gb, st, None)
    gb, (ts, hs), _ = best
    (nts, nhs), (nxt, nxh), _ = layout(ts, hs)
    group = gb // esize
    nv = group // vec
    unit = max(32, nv)
    items = max(nxt * nxh * w, min(ho, hs) * wo) * nv
    threads = min(FWD_THREADS, -(-items // unit) * unit)
    return FwdPlan("frame" if frame else "clip", slabs, t_in, t_out, ho, group,
                   -(-c // group), esize, vec, threads, slabs * nts * nhs * -(-c // group),
                   nxt * nxh * w * gb, c, t, h, ts, hs, nts, nhs, nxt, nxh, (k, s, p))


def _window_slices(k, s, out_shape):
    """For every tap (scan order t, h, w): the strided slices of the padded
    input that tap reads for all outputs."""
    for taps in itertools.product(*[range(ki) for ki in k]):
        yield (slice(None), slice(None)) + tuple(
            slice(a, a + si * (n - 1) + 1, si)
            for a, si, n in zip(taps, s, out_shape))


def max_pool3d_bwd_plain(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                         kernel_size, stride, padding) -> torch.Tensor:
    """Plain PyTorch version of the kernel: dx of ``y = max_pool3d(x)``
    (``padding`` in any form :func:`resolve_padding` takes).

    Each output's gradient goes to its first maximal tap; sums run in fp32
    (float64 for float64 inputs) and dx is cast to x's dtype."""
    k, s = _triple(kernel_size), _triple(stride)
    pads = resolve_padding(padding, x.shape[2:], k, s)
    p = tuple(lo for lo, _ in pads)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    flat = (*pads[2], *pads[1], *pads[0])
    xp = F.pad(x.to(acc), flat, value=float("-inf"))
    yf = y.to(acc)
    tap = torch.full(y.shape, -1, dtype=torch.int16, device=x.device)
    slices = list(_window_slices(k, s, y.shape[2:]))
    for ti, sl in enumerate(slices):
        tap = torch.where((xp[sl] == yf) & (tap < 0), ti, tap)
    dyf = dy.to(acc)
    dxp = torch.zeros(xp.shape, dtype=acc, device=x.device)
    for ti in reversed(range(len(slices))):
        dxp[slices[ti]] += torch.where(tap == ti, dyf, 0.0)
    t, h, w = x.shape[2:]
    return dxp[:, :, p[0]:p[0] + t, p[1]:p[1] + h, p[2]:p[2] + w].to(x.dtype)


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.dim() != 5:
        raise ValueError(f"max_pool3d {what}: x {tuple(x.shape)} must be (B, C, T, H, W)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"max_pool3d {what}: x {x.dtype} (want one of fp32, bf16)")
    if not x.is_cuda:
        raise ValueError(f"max_pool3d {what}: x must be on a CUDA device")
    if not x.is_contiguous(memory_format=_CL):
        raise ValueError(f"max_pool3d {what}: x must be channels_last_3d")


def _check_geometry(x_shape, k, s, pads: Pads, what: str) -> None:
    if (max(k) > MAX_WINDOW or min(k) < 1 or min(s) < 1
            or any(not 0 <= v < ki for ki, pair in zip(k, pads) for v in pair)):
        # a pad of the window's size or more would leave a window with no input
        raise ValueError(f"max_pool3d {what}: window {k}, stride {s}, "
                         f"padding {pads} outside the kernel's range")
    if min(out_sizes(x_shape[2:], k, s, pads)) < 1:
        raise ValueError(f"max_pool3d {what}: x {tuple(x_shape)} is smaller than the "
                         f"window {k} under padding {pads}")


def _check(x: torch.Tensor, y: torch.Tensor, k, s, pads: Pads) -> None:
    _check_x(x, "backward")
    _check_geometry(x.shape, k, s, pads, "backward")
    if y.dim() != 5:
        raise ValueError(f"max_pool3d backward: y {tuple(y.shape)} must be (B, C, T, H, W)")
    if y.dtype != x.dtype:
        raise TypeError(f"max_pool3d backward: x {x.dtype}, y {y.dtype} (want one dtype)")
    if not (y.is_cuda and x.device == y.device):
        raise ValueError("max_pool3d backward: x and y must be on one CUDA device")
    if not y.is_contiguous(memory_format=_CL):
        raise ValueError("max_pool3d backward: x and y must be channels_last_3d")
    want = out_sizes(x.shape[2:], k, s, pads)
    if tuple(y.shape[2:]) != want:
        raise ValueError(f"max_pool3d backward: y {tuple(y.shape)} is not the output "
                         f"{want} of x {tuple(x.shape)} under padding {pads}")


def _launch(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
            k, s, padding) -> torch.Tensor:
    """One backward call (one kernel launch): dx in channels_last_3d.
    ``padding`` as :func:`resolve_padding` takes it; the kernel gets the
    low pads and y's extents.  Counts the call as ``maxpool_bwd_s1`` (K3,
    a stride-1 pool) or ``maxpool_bwd_strided`` (K4), and a dy that reached
    it in another memory format and was copied first as
    ``maxpool_dy_copies``."""
    k, s = _triple(k), _triple(s)
    pads = resolve_padding(padding, x.shape[2:], k, s)
    _check(x, y, k, s, pads)
    if dy.shape != y.shape:
        raise ValueError(f"max_pool3d backward: dy {tuple(dy.shape)} != y "
                         f"{tuple(y.shape)}")
    plan = _cached_plan(tuple(x.shape), k, s, pads, x.dtype)
    p = plan.geometry[2]
    dy = dy.to(y.dtype)
    if not dy.is_contiguous(memory_format=_CL):
        dy = dy.contiguous(memory_format=_CL)
        tracing.count("maxpool_dy_copies")
    dx = torch.empty_like(x, memory_format=_CL)
    _, c, _, h, w = x.shape
    ho, wo = y.shape[3:]
    lib = _build.library()
    code = lib.vgs_maxpool3d_bwd(
        x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr(), plan.slabs,
        plan.t_in, h, w, c, plan.t_out, ho, wo, *k, *s, *p, plan.group,
        plan.threads, plan.t_strip, plan.h_strip, plan.x_frames, plan.x_rows,
        plan.y_frames, plan.y_rows, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "vgs_maxpool3d_bwd")
    tracing.count("maxpool_bwd_s1" if s == (1, 1, 1) else "maxpool_bwd_strided")
    return dx


@functools.lru_cache(maxsize=256)
def _fwd_launch_args(x_shape, k, s, flat_pads, dtype):
    """(y's shape, the kernel's 24 integer arguments as one C int array) of
    a forward call over x of ``x_shape``, ``flat_pads`` the (lo, hi) pairs
    of T, H and W flattened: its geometry checked, its plan made and its
    arguments converted once."""
    k, s, pads = _triple(k), _triple(s), _pairs(flat_pads)
    _check_geometry(x_shape, k, s, pads, "forward")
    plan = fwd_plan(x_shape, k, s, pads, dtype)
    b, c, _, h, w = x_shape
    to, ho, wo = out_sizes(x_shape[2:], k, s, pads)
    args = (plan.slabs, plan.t_in, h, w, c, plan.t_out, ho, wo, *k, *s, *plan.geometry[2],
            plan.group, plan.threads, plan.t_strip, plan.h_strip, plan.x_frames, plan.x_rows,
            int(dtype == torch.bfloat16))
    return (b, c, to, ho, wo), (ctypes.c_int * len(args))(*args)


def _launch_fwd(x: torch.Tensor, k, s, flat_pads) -> torch.Tensor:
    """One forward call (one kernel launch, counted as ``maxpool_fwd``): y
    in channels_last_3d, the only allocation.  ``flat_pads``: the (lo, hi)
    pairs of T, H and W, flattened.  The kernel gets the low pads and y's
    extents and clips every window at the input's ends."""
    _check_x(x, "forward")
    y_shape, args = _fwd_launch_args(tuple(x.shape), tuple(k), tuple(s), tuple(flat_pads),
                                     x.dtype)
    y = torch.empty(y_shape, dtype=x.dtype, device=x.device, memory_format=_CL)
    code = _build.library().vgs_maxpool3d_fwd(
        x.data_ptr(), y.data_ptr(), args, torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(code, "vgs_maxpool3d_fwd")
    tracing.count("maxpool_fwd")
    return y


def _pairs(flat: Sequence[int]) -> Pads:
    return tuple((int(flat[2 * i]), int(flat[2 * i + 1])) for i in range(3))


def _max_pool3d_fwd_cpu(x, kernel_size, stride, pads):
    return pool_forward(x, tuple(kernel_size), tuple(stride), _pairs(pads)).contiguous(
        memory_format=_CL)


def _max_pool3d_fwd_fake(x, kernel_size, stride, pads):
    out = out_sizes(x.shape[2:], kernel_size, stride, _pairs(pads))
    return torch.empty((*x.shape[:2], *out), dtype=x.dtype, device=x.device,
                       memory_format=_CL)


# The operator vgs_torch::max_pool3d_fwd: y of x (B, C, T, H, W) in
# channels_last_3d, ``pads`` the (lo, hi) pairs of T, H and W flattened; the
# kernel on CUDA, pool_forward on the CPU, and a fake for torch.export.  It
# is registered through torch.library's operator API rather than
# torch.library.custom_op, whose Python autograd layer dispatches each call
# twice: on the host of an H100 machine that made a pool's forward cost
# 86-107 us against 22-26 us for the library's (25-31 us this way), and an
# S3D step makes 26 of them right after the augmentation waits for the
# device.  It has no autograd kernel: _MaxPool3d calls it with autograd off.
_LIB = torch.library.Library("vgs_torch", "FRAGMENT")
_LIB.define("max_pool3d_fwd(Tensor x, int[] kernel_size, int[] stride, int[] pads) -> Tensor")
_LIB.impl("max_pool3d_fwd", _launch_fwd, "CUDA")
_LIB.impl("max_pool3d_fwd", _max_pool3d_fwd_cpu, "CPU")
torch.library.register_fake("vgs_torch::max_pool3d_fwd", _max_pool3d_fwd_fake, lib=_LIB)
max_pool3d_fwd_op = torch.ops.vgs_torch.max_pool3d_fwd.default


class _MaxPool3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, s, p):
        with tracing.span("maxpool_fwd"):
            if x.is_cuda:
                y = max_pool3d_fwd_op(x, k, s, [v for pair in p for v in pair])
            else:
                y = pool_forward(x, k, s, p)
        ctx.save_for_backward(x, y)
        ctx.geom = (k, s, p)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        k, s, p = ctx.geom
        with tracing.span("maxpool_bwd"):
            if x.device.type == "cpu":
                return max_pool3d_bwd_plain(x, y, dy, k, s, p), None, None, None
            return _launch(x, y, dy, k, s, p), None, None, None


def max_pool3d(x: torch.Tensor, kernel_size, stride, padding: Padding = 0) -> torch.Tensor:
    """Max pooling (``padding``: an int or one per axis, PyTorch's
    symmetric padding; ``(lo, hi)`` pairs; or ``"SAME"``): on CUDA tensors
    the forward kernel and the K3/K4 backward, on CPU tensors
    :func:`pool_forward` and the plain backward."""
    k, s = _triple(kernel_size), _triple(stride)
    pads = resolve_padding(padding, x.shape[2:], k, s)
    if x.is_cuda:
        x = x.contiguous(memory_format=_CL)
    return _MaxPool3d.apply(x, k, s, pads)
