"""The stems' convolution: a dense 3D convolution whose input has few
channels (C < 8), with a hand-written tensor-core forward on CUDA tensors.

The first convolution of every 3D backbone reads the clip: 3 channels (2
for a Flow stem), which no tensor-core kernel of the library takes, so on
a bf16 CUDA tensor cuDNN copies x to NCHW fp32, runs an FFMA kernel and
copies y back.  Here the forward is one launch of
``csrc/stem_conv_fwd.cu`` through the operator ``vgs_torch::stem_conv3d_fwd``:
it reads the clip as it arrives, (B, T, H, W, C) at any strides in fp32
or bf16 (no layout copy), rounds each element to bf16 as it stages it (the ``x.to(dtype)`` of
the library path), takes any (lo, hi) padding by reading zero outside x,
and writes y in bf16 as the (B, F, T', H', W') ``channels_last_3d`` tensor
the batch norm takes.  A frame table (SlowFast's Slow pathway) makes the
convolution read frames ``frames[t]`` of x in place.  bf16 products are
summed in fp32 and rounded once.  :func:`plan` is the launch's plan, a pure
function; :func:`stem_conv3d_plain` the plain version that the CPU tests
and ``chip_smoke.py`` hold the kernel to, and the operator's CPU kernel.

The backward stays the library's: the weight (and bias) gradient of the
convolution on the bf16 input, ``aten.convolution_backward``, as autograd
runs it for ``F.conv3d``.  Only a pass that records gradients keeps that
bf16 input (x itself where it is bf16 already, as the library path kept
it); a pass under ``no_grad`` (MoCo's key pass) keeps nothing.

:func:`routes` decides which convolutions take the kernel: a CUDA tensor,
bf16 compute, C_in < 8, F a multiple of 8, one group, no dilation.
``models/layers.py:conv3d`` calls it, and is the one place every 3D
convolution of the backbones goes through.  Each call of the kernel counts
once as ``stem_conv_fwd`` (``utils/tracing.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import _build
from .maxpool import Pads, out_sizes

MAX_CHANNELS = 8          # C_in below this takes the kernel (csrc's kMaxC + 1)
MAX_SMEM_BYTES = 232448   # 227 KB, the most shared memory one block may take
F_BLOCK = 64              # output channels a block computes
SM_SMEM_BYTES = 233472    # shared memory of one SM; a block takes 1 KB more than it asks
SM_REGISTERS = 65536


class Variant(NamedTuple):
    """One instantiation of the kernel, as built (``STEM_VARIANTS`` in the
    source, read by :func:`kernel_variants`)."""
    index: int      # its index in the source's list
    nt: int         # 8-channel columns of F a block computes
    mt: int         # 16-position tiles a warp computes
    max_warps: int  # its launch bound's threads / 32
    minb: int       # its launch bound's blocks per SM
    regs: int       # registers a thread


@functools.lru_cache(maxsize=2)
def kernel_variants(x_bf16: bool) -> Tuple[Variant, ...]:
    """The built kernel's instantiations for an fp32 or a bf16 x, with the
    registers a thread that the CUDA runtime reports for each."""
    rows = (ctypes.c_longlong * (6 * 16))()
    n = _build.library().vgs_stem_conv3d_variants(rows, 16)
    if not 0 < n <= 16:
        raise RuntimeError(f"vgs_stem_conv3d_variants: CUDA error {-n}" if n < 0 else
                           f"vgs_stem_conv3d_variants: {n} instantiations")
    return tuple(Variant(i, nt, mt, maxt // 32, minb, regs_bf16 if x_bf16 else regs_f32)
                 for i, (nt, mt, maxt, minb, regs_f32, regs_bf16)
                 in enumerate(zip(*[iter(rows[:6 * n])] * 6)))


# The plan's cost model, in instructions of one block: a staged element
# (a 16-byte load of four, their rounding and one 8-byte shared store) and
# one k-step of one 16-position tile (four A loads, their address sums and
# masks, and one mma.sync per 8 channels)
STAGE_COST = 2
TILE_STEP_COST = 12
_CL = torch.channels_last_3d


class Plan(NamedTuple):
    """The launch plan of one call (see ``csrc/stem_conv_fwd.cu``)."""
    out: Tuple[int, int, int]   # To, Ho, Wo
    group: int      # elements of one (dt, dh) row of taps in K (kw*C, even)
    lead: int       # masked elements before each row of taps (0 or 1)
    kspd: int       # k-steps of 16 per dt
    nt: int         # 8-channel columns a block computes (1, 2, 4, 8)
    rh: int         # output rows of a unit (a block's strip)
    wt: int         # 16-position tiles per output row
    sr: int         # staged rows per frame
    rp: int         # elements per staged row
    zoff: int       # a position's window starts at w*sw*C + zoff in a staged row
    xoff: int       # staged element e holds x's element e - xoff of its row
    hb: int         # strips per clip
    units: int      # B * hb
    warps: int
    smem: int       # dynamic shared memory of a block, bytes
    variant: int    # the instantiation's index (``Variant.index``)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def smem_bytes(kt: int, kspd: int, nt: int, sr: int, rp: int, warps: int) -> int:
    """A block's shared memory: the weights (nt*8 rows of K + 8), the A
    offset table, the ring of kt staged frames and the warps' y buffers
    (``layout`` in the source)."""
    a16 = lambda n: (n + 15) // 16 * 16   # noqa: E731
    return (a16(nt * 8 * (kt * kspd * 16 + 8) * 2) + kspd * 96 + a16(kt * sr * rp * 2)
            + warps * 16 * (nt * 8 + 8) * 2)


@functools.lru_cache(maxsize=256)
def plan(x_shape, tsel: int, w_shape, stride, pads: Pads, variants: Tuple[Variant, ...],
         rh: Optional[int] = None) -> Plan:
    """The launch plan of a convolution over x of ``x_shape`` (B, T, H, W,
    C) reading ``tsel`` frames (the frame table's length, or T), with
    weights ``w_shape`` (F, C, kt, kh, kw), ``stride`` and ``(lo, hi)``
    ``pads``, on the kernel's instantiations ``variants``
    (:func:`kernel_variants`).  ``rh`` fixes a unit's output rows.  Of the
    strips and instantiations whose blocks fit an SM, the plan takes
    the one that keeps the most warps on an SM (up to 16: measured on the
    H100 at the stems of the 3D backbones, the kernel's time fell with
    them), then the most blocks, then
    the fewest instructions a clip's frame (:data:`STAGE_COST`,
    :data:`TILE_STEP_COST`)."""
    b, _, h, w, c = x_shape
    f, cw, kt, kh, kw = w_shape
    st, sh, sw = stride
    if cw != c:
        raise ValueError(f"stem_conv3d: x has {c} channels, the weights {cw}")
    to, ho, wo = out_sizes((tsel, h, w), (kt, kh, kw), stride, pads)
    if min(to, ho, wo) < 1:
        raise ValueError(f"stem_conv3d: x {tuple(x_shape)} is smaller than the kernel "
                         f"{(kt, kh, kw)} under padding {pads}")
    pw = pads[2][0]
    # staged rows start z columns before the low pad, so that x's rows load
    # in aligned fours; a pair of A elements is one 4-byte load where sw*C
    # is even, with one masked element before each row of taps if z*C is odd
    z = next(z for z in range(4) if ((pw + z) * c) % 4 == 0)
    zoff, xoff = z * c, (pw + z) * c
    lead = zoff % 2 if (sw * c) % 2 == 0 else 0
    group = kw * c + lead + (kw * c + lead) % 2
    kspd = -(-kh * group // 16)
    nt = _pow2_at_least(min(-(-f // 8), F_BLOCK // 8))
    wt = -(-wo // 16)
    need = (wt * 16 - 1) * sw * c + zoff + group - lead
    rp = -(-need // 4) * 4

    def option(r, v):
        """(fits, warps, sr, smem, blocks an SM) of a strip of r rows."""
        warps = -(-r * wt // v.mt)
        sr = (r - 1) * sh + kh
        smem = smem_bytes(kt, kspd, nt, sr, rp, warps)
        regs = -(-v.regs // 8) * 8   # a warp's registers come in 256s
        blocks = min(SM_SMEM_BYTES // (smem + 1024), SM_REGISTERS // (warps * 32 * regs),
                     64 // warps)
        ok = warps <= v.max_warps and smem <= MAX_SMEM_BYTES and blocks >= v.minb
        return ok, warps, sr, smem, blocks

    def cost(r):
        sr = (r - 1) * sh + kh
        per_frame = min(st, kt) * sr * rp * STAGE_COST + r * wt * kt * kspd * (TILE_STEP_COST + nt)
        return -(-ho // r) * per_frame

    # the most warps an SM holds (up to 16), then the most blocks (one's
    # staging overlaps another's products), then the fewest instructions
    best = None
    for v in (v for v in variants if v.nt == nt):
        for r in ([rh] if rh is not None else range(1, ho + 1)):
            ok, warps, sr, smem, blocks = option(r, v)
            if not ok:
                continue
            key = (-min(warps * blocks, 16), -blocks, cost(r), -r)
            if best is None or key < best[0]:
                best = (key, r, v, warps, sr, smem)
    if best is None:
        raise ValueError(f"stem_conv3d: no strip of x {tuple(x_shape)} fits a block"
                         + ("" if rh is None else f" at {rh} rows"))
    _, rh, v, warps, sr, smem = best
    hb = -(-ho // rh)
    return Plan((to, ho, wo), group, lead, kspd, nt, rh, wt, sr, rp, zoff, xoff, hb, b * hb,
                warps, smem, v.index)


def _pairs(flat: Sequence[int]) -> Pads:
    return tuple((int(flat[2 * i]), int(flat[2 * i + 1])) for i in range(3))


@functools.lru_cache(maxsize=256)
def launch_args(x_shape, x_strides, tsel: int, w_shape, w_strides, stride, flat_pads,
                x_bf16: bool):
    """(y's shape, the kernel's 43 integers as one C long long array) of a
    call: its plan made and its arguments converted once per geometry."""
    pads = _pairs(flat_pads)
    p = plan(x_shape, tsel, w_shape, stride, pads, kernel_variants(x_bf16))
    b, t, h, w, c = x_shape
    f, _, kt, kh, kw = w_shape
    to, ho, wo = p.out
    args = (b, t, h, w, c, tsel, to, ho, wo, f, kt, kh, kw, *stride, *(lo for lo, _ in pads),
            p.group, p.lead, p.kspd, p.rh, p.wt, p.sr, p.rp, p.zoff, p.xoff, p.hb, p.units,
            p.warps, p.variant, int(x_bf16), *x_strides, *w_strides)
    return (b, f, to, ho, wo), (ctypes.c_longlong * len(args))(*args)


def _check(x, w, bias, frames) -> None:
    if x.dim() != 5:
        raise ValueError(f"stem_conv3d: x {tuple(x.shape)} must be (B, T, H, W, C)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stem_conv3d: x {x.dtype} (want fp32 or bf16)")
    if w.dim() != 5 or w.dtype != torch.bfloat16 or w.device != x.device:
        raise ValueError(f"stem_conv3d: weights {tuple(w.shape)} {w.dtype} must be bf16 "
                         "(F, C, kt, kh, kw) on x's device")
    if w.shape[1] >= MAX_CHANNELS or w.shape[0] % 8:
        raise ValueError(f"stem_conv3d: weights {tuple(w.shape)}: C must be below "
                         f"{MAX_CHANNELS} and F a multiple of 8")
    if bias is not None and (bias.shape != (w.shape[0],) or bias.dtype != torch.bfloat16
                             or not bias.is_contiguous() or bias.device != x.device):
        raise ValueError("stem_conv3d: bias must be a contiguous bf16 (F) on x's device")
    if frames is not None and (frames.dim() != 1 or frames.dtype != torch.int64
                               or not frames.is_contiguous() or frames.device != x.device):
        raise ValueError("stem_conv3d: frames must be a contiguous int64 (T') on x's device")


def _launch(x, w, bias, stride, pads, frames):
    """One forward call (one kernel launch, counted as ``stem_conv_fwd``):
    y in channels_last_3d, the only allocation."""
    _check(x, w, bias, frames)
    tsel = x.shape[1] if frames is None else frames.shape[0]
    y_shape, args = launch_args(tuple(x.shape), x.stride(), tsel, tuple(w.shape), w.stride(),
                                tuple(stride), tuple(pads), x.dtype == torch.bfloat16)
    y = torch.empty(y_shape, dtype=torch.bfloat16, device=x.device, memory_format=_CL)
    code = _build.library().vgs_stem_conv3d_fwd(
        x.data_ptr(), w.data_ptr(), 0 if bias is None else bias.data_ptr(),
        0 if frames is None else frames.data_ptr(), y.data_ptr(), args,
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    _build.check(code, "vgs_stem_conv3d_fwd")
    tracing.count("stem_conv_fwd")
    return y


def conv_pads(x: torch.Tensor, pads: Pads):
    """x (B, C, T, H, W) and the padding ``F.conv3d`` takes for the (lo,
    hi) ``pads`` of T, H and W: x and the low pads where every axis pads
    symmetrically, else x zero-padded (lo, hi) first and none."""
    if all(lo == hi for lo, hi in pads):
        return x, [lo for lo, _ in pads]
    return F.pad(x, (*pads[2], *pads[1], *pads[0])), [0, 0, 0]


def stem_conv3d_plain(x, w, bias, stride, pads, frames=None):
    """The plain version: ``F.conv3d`` in ``w``'s dtype on x (B, T, H, W, C)
    (frames ``frames`` of it), ``pads`` the (lo, hi) pairs of T, H and W
    flattened (:func:`conv_pads`); y (B, F, T', H', W') in
    channels_last_3d."""
    if frames is not None:
        x = x.index_select(1, frames)
    xn, padding = conv_pads(x.permute(0, 4, 1, 2, 3).to(w.dtype), _pairs(pads))
    return F.conv3d(xn, w, bias, tuple(stride), padding).contiguous(memory_format=_CL)


def _fake(x, w, bias, stride, pads, frames):
    tsel = x.shape[1] if frames is None else frames.shape[0]
    out = out_sizes((tsel, *x.shape[2:4]), w.shape[2:], stride, _pairs(pads))
    return torch.empty((x.shape[0], w.shape[0], *out), dtype=w.dtype, device=x.device,
                       memory_format=_CL)


# The operator vgs_torch::stem_conv3d_fwd: y of x (B, T, H, W, C), w (F, C,
# kt, kh, kw), ``pads`` the (lo, hi) pairs flattened; the kernel on CUDA,
# the plain version on the CPU, a fake for torch.export.  Registered as the
# pool forward is (ops/maxpool.py), through torch.library's operator API:
# no Python autograd layer; _StemConv3d calls it with autograd off.
_LIB = torch.library.Library("vgs_torch", "FRAGMENT")
_LIB.define("stem_conv3d_fwd(Tensor x, Tensor w, Tensor? bias, int[] stride, int[] pads, "
            "Tensor? frames) -> Tensor")
_LIB.impl("stem_conv3d_fwd", _launch, "CUDA")
_LIB.impl("stem_conv3d_fwd", stem_conv3d_plain, "CPU")
torch.library.register_fake("vgs_torch::stem_conv3d_fwd", _fake, lib=_LIB)
stem_conv3d_fwd_op = torch.ops.vgs_torch.stem_conv3d_fwd.default


class _StemConv3d(torch.autograd.Function):
    """The operator's forward; the library's backward of the convolution on
    the bf16 input (frames ``frames`` of x), which the forward keeps."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, pads, frames):
        y = stem_conv3d_fwd_op(x, w, bias, stride, pads, frames)
        xs = x if frames is None else x.index_select(1, frames)
        ctx.save_for_backward(xs.to(w.dtype), w, frames)
        ctx.geom = (x.shape, x.dtype, tuple(stride), _pairs(pads), bias is not None)
        return y

    @staticmethod
    def backward(ctx, dy):
        xs, w, frames = ctx.saved_tensors
        x_shape, x_dtype, stride, p, has_bias = ctx.geom
        xn, padding = conv_pads(xs.permute(0, 4, 1, 2, 3), p)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = torch.ops.aten.convolution_backward(
            dy, xn, w, [w.shape[0]] if has_bias else None, list(stride), padding, [1, 1, 1],
            False, [0, 0, 0], 1, [need_x, need_w, has_bias and need_b])
        if dx is not None:
            if padding == [0, 0, 0] and any(lo for lo, _ in p):
                (lt, _), (lh, _), (lw, _) = p
                dx = dx[:, :, lt:lt + xs.shape[1], lh:lh + xs.shape[2], lw:lw + xs.shape[3]]
            dx = dx.permute(0, 2, 3, 4, 1).to(x_dtype)
            if frames is not None:
                dx = torch.zeros(x_shape, dtype=x_dtype, device=dx.device).index_add_(
                    1, frames, dx)
        return dx, dw, db, None, None, None


def routes(device: torch.device, dtype: torch.dtype, weight: torch.Tensor, groups: int = 1,
           dilation=1) -> bool:
    """Whether a 3D convolution takes the kernel: on a CUDA device, computed
    in bf16, C_in < 8, F a multiple of 8, one group and no dilation."""
    dil = tuple(dilation) if isinstance(dilation, (tuple, list)) else (dilation,) * 3
    return (device.type == "cuda" and dtype == torch.bfloat16 and weight.dim() == 5
            and weight.shape[1] < MAX_CHANNELS and weight.shape[0] % 8 == 0 and groups == 1
            and dil == (1, 1, 1))


def stem_conv3d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride,
                pads: Pads, dtype: torch.dtype,
                frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The convolution of x (B, C, T, H, W) (frames ``frames`` of it) with
    the fp32 parameters ``weight`` and ``bias`` cast to ``dtype``, ``pads``
    the (lo, hi) pair of each axis: the operator, and the library's backward
    where a gradient is recorded."""
    xb = x.permute(0, 2, 3, 4, 1)
    w = weight.to(dtype)
    b = None if bias is None else bias.to(dtype)
    flat = [v for pair in pads for v in pair]
    stride = [int(s) for s in stride]
    if torch.is_grad_enabled() and (w.requires_grad or xb.requires_grad
                                    or (b is not None and b.requires_grad)):
        return _StemConv3d.apply(xb, w, b, stride, flat, frames)
    return stem_conv3d_fwd_op(xb, w, b, stride, flat, frames)
