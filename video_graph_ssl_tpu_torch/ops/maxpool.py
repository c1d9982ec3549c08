"""3D max pooling whose backward is a hand-written kernel (K3 and K4).

Counterpart of ``video_graph_ssl_tpu/ops/pallas/maxpool_kernel.py``.  The
forward is the library ``F.max_pool3d``, as the JAX kernels keep
``reduce_window`` for theirs; it saves x and y, not indices.  The backward,
on a CUDA tensor, is one launch of ``csrc/maxpool_bwd.cu``: a block per
slab (a whole clip, or one frame when the window and stride are 1 in t) and
channel group stages the slab's x in shared memory, finds each output's
first maximal tap there, then stages dy in the same space and gathers dx;
device memory sees x, y and dy read once and dx written once, and no
scratch.  :func:`bwd_plan` is that launch's plan, a pure function.  On a
CPU tensor the backward runs :func:`max_pool3d_bwd_plain`, the plain
PyTorch version that the tests and ``chip_smoke.py`` hold the kernel to.
There is no fallback from the kernel to the plain version.

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
    channels: int     # the call's C and T
    frames: int

    def extent(self, block: int):
        """What block ``block`` owns, in the kernel's order: (b, x's frames
        [t0, t1), y's frames [to0, to1), channels [c0, c1))."""
        slab, g = divmod(block, self.groups)
        c0 = g * self.group
        chans = (c0, min(c0 + self.group, self.channels))
        if self.slab == "frame":
            b, t = divmod(slab, self.frames)
            return b, (t, t + 1), (t, t + 1), chans
        return slab, (0, self.t_in), (0, self.t_out), chans


@functools.lru_cache(maxsize=256)
def _cached_plan(x_shape, k, s, p, dtype) -> BwdPlan:
    return bwd_plan(x_shape, k, s, p, dtype)


def bwd_plan(x_shape, kernel_size, stride, padding, dtype,
             group_bytes: int | None = None) -> BwdPlan:
    """The launch of one backward call for x of ``x_shape`` (B, C, T, H, W):
    one block per (slab, channel group).  The group is the widest of
    ``GROUP_BYTES`` that C fills and that leaves room for two blocks per SM
    (the narrowest where none does), unless ``group_bytes`` is given.
    Raises ``ValueError`` when a slab's shared memory exceeds what one block
    may take."""
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    b, c, t, h, w = (int(v) for v in x_shape)
    to, ho, wo = ((n + 2 * pi - ki) // si + 1
                  for n, ki, si, pi in zip((t, h, w), k, s, p))
    esize = dtype.itemsize
    frame = k[0] == 1 and s[0] == 1 and p[0] == 0
    slabs, t_in, t_out = (b * t, 1, 1) if frame else (b, t, to)
    vec = 16 // esize if c % (16 // esize) == 0 else 1
    n_in, n_out = t_in * h * w, t_out * ho * wo

    def smem_of(nbytes):
        return max(n_in, n_out) * nbytes + n_out * (nbytes // esize)

    if group_bytes is None:
        fits = [gb for gb in GROUP_BYTES if gb == GROUP_BYTES[0]
                or (gb // esize <= c and smem_of(gb) <= TWO_BLOCKS_SMEM)]
        group_bytes = fits[-1]
    smem, group = smem_of(group_bytes), group_bytes // esize
    groups = -(-c // group)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"max_pool3d backward: a {'frame' if frame else 'clip'} slab of x "
            f"{tuple(x_shape)} needs {smem} bytes of shared memory per block, "
            f"above the {MAX_SMEM_BYTES} one block may take")
    # whole warps, and a whole number of positions (group // vec threads each)
    unit = max(32, group // vec)
    threads = min(MAX_THREADS, -(-max(n_in, n_out) * (group // vec) // unit) * unit)
    return BwdPlan("frame" if frame else "clip", slabs, t_in, t_out, group, groups,
                   esize, vec, threads, slabs * groups, smem, c, t)


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
        plan.threads, int(x.dtype == torch.bfloat16),
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
