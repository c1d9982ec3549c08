"""3D max pooling whose backward is a hand-written kernel (K3 and K4).

Counterpart of ``video_graph_ssl_tpu/ops/pallas/maxpool_kernel.py``.  The
forward is the library ``F.max_pool3d``, as the JAX kernels keep
``reduce_window`` for theirs; it saves x and y, not indices.  The backward,
on a CUDA tensor, is one launch of ``csrc/maxpool_bwd.cu``: a block per
slab (a whole clip, or one frame when the window and stride are 1 in t) and
channel group stages the slab's x in shared memory, finds each output's
first maximal tap there, then stages dy in the same space and gathers dx;
device memory sees x, y and dy read once and dx written once, and no
scratch.  A slab above the 227 KB one block may take (stage 1's pool and
Mixed_3b/3c's at 224x224) is cut into strips of dx rows, along H and where
needed along T; each block stages, with a halo, the outputs whose windows
cover its rows and the x those windows read, and writes its own dx rows
only, so the halo rows' x, y and dy are read by two blocks.
:func:`bwd_plan` is that launch's plan, a pure function.  On a CPU tensor
the backward runs :func:`max_pool3d_bwd_plain`, the plain PyTorch version
that the tests and ``chip_smoke.py`` hold the kernel to.  There is no
fallback from the kernel to the plain version.

The one limit left is W: a strip of one input row of one frame, with its
halo, must fit one block.  The widest W that plans (32-byte channel
groups; bf16 / fp32): 1,320 / 1,383 for the (1,3,3)/(1,2,2) pools, 279 /
284 for (3,3,3)/(2,2,2), 1,709 / 1,761 for (2,2,2)/(2,2,2) and 246 / 266
for the stride-1 (3,3,3) pools: at least 8x the W of the S3D pools of
each geometry at 224x224 (112 and 56, 28, 14, and 28 at Mixed_3b/3c).

Ties go to the first maximal tap in t, h, w scan order, PyTorch's rule.
Both versions add the contributions to one input in increasing output
order, as PyTorch's CPU backward does, so in fp32 they agree with it bit
for bit.

Tensors are ``(B, C, T, H, W)``; the kernel takes them in
``torch.channels_last_3d`` memory, the backbone's layout.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import _build

# Backward calls since the last reset (one call = one kernel launch):
# K3, stride-1 pools; K4, strided pools.
launches_s1 = 0
launches_strided = 0
# dy cotangents that reached the kernel in another memory format and were
# copied to channels_last_3d first.
dy_copies = 0

MAX_WINDOW = 3
MAX_SMEM_BYTES = 232448   # 227 KB, the most shared memory one block may take
MAX_THREADS = 512         # the kernel's __launch_bounds__
# Channels per block, in bytes of one position: 32 (a DRAM sector) to 256.
# On the H100 a wider group (longer runs of each position read at once)
# helped at the S3D pools while two blocks still fit on an SM, and mostly
# hurt beyond.
GROUP_BYTES = (32, 64, 128, 256)
TWO_BLOCKS_SMEM = 115712  # the most shared memory a block may take with two per SM
_CL = torch.channels_last_3d


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        assert len(v) == 3
        return tuple(int(i) for i in v)
    return (int(v),) * 3


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
    geometry: Tuple[Tuple[int, int, int], ...]   # window, stride, padding

    def block(self, i: int) -> Block:
        """Block ``i``, in the kernel's order: the channel group fastest,
        then the H strip, the T strip, the slab."""
        rest, g = divmod(i, self.groups)
        rest, hi = divmod(rest, self.h_strips)
        slab, ti = divmod(rest, self.t_strips)
        c0 = g * self.group
        chans = (c0, min(c0 + self.group, self.channels))
        (kt, kh, _), (st, sh, _), (pt, ph, _) = self.geometry
        ho = (self.rows + 2 * ph - kh) // sh + 1
        h0 = hi * self.h_strip
        h1 = min(self.rows, h0 + self.h_strip)
        oh0, oh1, xh0, xh1 = axis_cover(h0, h1, kh, sh, ph, self.rows, ho)
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
def _cached_plan(x_shape, k, s, p, dtype) -> BwdPlan:
    return bwd_plan(x_shape, k, s, p, dtype)


def bwd_plan(x_shape, kernel_size, stride, padding, dtype,
             group_bytes: int | None = None) -> BwdPlan:
    """The launch of one backward call for x of ``x_shape`` (B, C, T, H, W).

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
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    b, c, t, h, w = (int(v) for v in x_shape)
    to, ho, wo = ((n + 2 * pi - ki) // si + 1
                  for n, ki, si, pi in zip((t, h, w), k, s, p))
    esize = dtype.itemsize
    frame = k[0] == 1 and s[0] == 1 and p[0] == 0
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
    return BwdPlan("frame" if frame else "clip", slabs, t_in, t_out, group, groups,
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


def _window_slices(k, s, out_shape):
    """For every tap (scan order t, h, w): the strided slices of the padded
    input that tap reads for all outputs."""
    for taps in itertools.product(*[range(ki) for ki in k]):
        yield (slice(None), slice(None)) + tuple(
            slice(a, a + si * (n - 1) + 1, si)
            for a, si, n in zip(taps, s, out_shape))


def max_pool3d_bwd_plain(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                         kernel_size, stride, padding) -> torch.Tensor:
    """Plain PyTorch version of the kernel: dx of ``y = max_pool3d(x)``.

    Each output's gradient goes to its first maximal tap; sums run in fp32
    (float64 for float64 inputs) and dx is cast to x's dtype."""
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    pads = (p[2], p[2], p[1], p[1], p[0], p[0])
    xp = F.pad(x.to(acc), pads, value=float("-inf"))
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


def _check(x: torch.Tensor, y: torch.Tensor, k, s, p) -> None:
    if x.dim() != 5 or y.dim() != 5:
        raise ValueError(f"max_pool3d backward: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must be (B, C, T, H, W)")
    if x.dtype not in (torch.float32, torch.bfloat16) or y.dtype != x.dtype:
        raise TypeError(f"max_pool3d backward: x {x.dtype}, y {y.dtype} "
                        "(want one of fp32, bf16)")
    if not (x.is_cuda and y.is_cuda and x.device == y.device):
        raise ValueError("max_pool3d backward: x and y must be on one CUDA device")
    if not (x.is_contiguous(memory_format=_CL) and y.is_contiguous(memory_format=_CL)):
        raise ValueError("max_pool3d backward: x and y must be channels_last_3d")
    if max(k) > MAX_WINDOW or min(k) < 1 or min(s) < 1 or min(p) < 0:
        raise ValueError(f"max_pool3d backward: window {k}, stride {s}, "
                         f"padding {p} outside the kernel's range")


def _launch(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
            k, s, p) -> torch.Tensor:
    """One backward call (one kernel launch): dx in channels_last_3d."""
    global launches_s1, launches_strided, dy_copies
    _check(x, y, k, s, p)
    if dy.shape != y.shape:
        raise ValueError(f"max_pool3d backward: dy {tuple(dy.shape)} != y "
                         f"{tuple(y.shape)}")
    plan = _cached_plan(tuple(x.shape), k, s, p, x.dtype)
    dy = dy.to(y.dtype)
    if not dy.is_contiguous(memory_format=_CL):
        dy = dy.contiguous(memory_format=_CL)
        dy_copies += 1
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
    if s == (1, 1, 1):
        launches_s1 += 1
    else:
        launches_strided += 1
    return dx


class _MaxPool3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, s, p):
        y = F.max_pool3d(x, k, s, p)
        if x.is_cuda:
            y = y.contiguous(memory_format=_CL)
        ctx.save_for_backward(x, y)
        ctx.geom = (k, s, p)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        k, s, p = ctx.geom
        if x.device.type == "cpu":
            return max_pool3d_bwd_plain(x, y, dy, k, s, p), None, None, None
        return _launch(x, y, dy, k, s, p), None, None, None


def max_pool3d(x: torch.Tensor, kernel_size, stride, padding=0) -> torch.Tensor:
    """``F.max_pool3d`` (PyTorch padding semantics) with the K3/K4 backward
    on CUDA tensors and the plain backward on CPU tensors."""
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    if x.is_cuda:
        x = x.contiguous(memory_format=_CL)
    return _MaxPool3d.apply(x, k, s, p)
