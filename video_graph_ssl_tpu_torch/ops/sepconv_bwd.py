"""Kernel wrapper of the SepConv pair's three-sweep backward (K5).

Counterpart of ``video_graph_ssl_tpu/ops/pallas/sepconv_bwd.py`` (K5) and
``ops/pallas/sepconv_bwd_grid.py`` (K6): one CUDA family,
``csrc/sepconv_bwd.cu``, covers every shape of the pair (k = 3, stride 1,
pad 1).  :func:`sepconv_bwd` takes CUDA tensors only; its plain version is
``ops/fused_sepconv.py:bwd_reference``, which ``FusedSepConvTrain`` runs
for CPU tensors.  Arguments and outputs are those of ``bwd_reference``.
A call runs the kernel's three stages (``vgs_sepconv_bwd_stage1..3``, one
per sweep); ranks that each hold rows of one batch pass a ``reduce`` that
sums each stage's two BN sums over the ranks before the next stage.

:func:`plan` is the launch of one call as a pure function of the shape:
its route (``tc``, the tensor-core products of ``csrc/sepconv_bwd_tc.cuh``,
for bf16 with C and F multiples of 8; ``simt``, fp32 FMA on the CUDA cores,
for the rest), each product's tile, ring depth, shared memory and grid,
the weight-gradient row splits, and where each scratch and output lies in
the call's two buffers.  :func:`tap_gemm` and :func:`tap_wgrad` are the
products' index maps in plain PyTorch (tests only).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build, fused_sepconv

# Wrapper calls since the last reset (one call = the three sweeps):
# all routes, and the tensor-core route alone.
launches = 0
launches_tc = 0
# C entries those calls launched (three stages each), and the cross-rank
# reductions of their BN sums (two per call on ranks, none on one process)
stage_calls = 0
reduces = 0
# cotangents that reached the kernel in another dtype than the compute
# dtype and were converted (copied) first; any layout is read in place.
g_copies = 0

_CL = torch.channels_last_3d
SMS = 132                 # the H100's streaming multiprocessors
MAX_SMEM_BYTES = 232448   # 227 KB, the most shared memory one block may take

# simt route: 64 x 64 fp32 tiles, 16 deep (conv_taps_kernel, wgrad_taps_kernel)
SIMT_TILE = (64, 64, 16)
SIMT_THREADS = 256
# Target number of blocks of a simt weight-gradient product: enough to fill
# the card's SMs several times over.  Each row split keeps one fp32 partial
# of the weight gradient, so the count also bounds that scratch.
_WGRAD_BLOCKS = 1024
_MAX_SPLITS = 64

# tc route (csrc/sepconv_bwd_tc.cuh): conv products take 128 rows by BN
# channels per block and 32-channel K chunks.  The temporal ones (P2, P3)
# walk (tap, chunk) pairs through a 3-stage cp.async ring and stage their
# epilogue's [128][BN] input tile behind it; the spatial ones (P1, P5)
# stage each 16-channel chunk's rows once with a halo of W + 1 rows on
# either side, plus the nine taps' weight tiles, in a 2-stage ring (two
# 128 x 128 blocks fit an SM).  Weight products
# take a WBM x WBN channel tile of three taps that share each staged D
# chunk, 32-row K chunks, a 4-stage ring.
TC_BM = 128
TC_BK = 32
TC_HALO_BK = 16
TC_CONV_STAGES = 3
TC_HALO_STAGES = 2
TC_WGRAD_STAGES = 4
TC_CONV_THREADS = 256
TC_WGRAD_THREADS = 128
TC_BN = (128, 64, 32, 16)
# Relative speed of a conv block of each width (about the TFLOP/s these
# products reached on the H100 at the S3D shapes): a narrow tile stages as
# much A per chunk for fewer products.
_TC_BN_RATE = {128: 225, 64: 170, 32: 100, 16: 70}
TC_WG_TILES = (32, 64)
TC_SHARED_TAPS = 3
_PAD = 8                       # bf16 of padding per staged row
# Weight products run in whole waves: 3 blocks of 128 threads fit an SM
# (shared memory), and the row splits make about _TC_WGRAD_WAVES waves.
TC_WGRAD_WAVE = 3 * SMS
_TC_WGRAD_WAVES = 2
_TC_MAX_SPLITS = 256
TC_MIN_SPLIT_ROWS = 512
_EW_THREADS = 2048 * SMS       # threads of the 16-byte elementwise pass

# the products in sweep order: (name, A's channels, N, taps, spatial)
PRODUCTS = ("P1 y1", "P2 y2", "P3 da", "P4 dWt", "P5 dx", "P6 dWs")
F32_BUFFERS = ("dws", "dwt", "sums", "bn1", "bn2", "m1", "m2", "part", "wpart")
ACT_BUFFERS = ("w1", "w2", "w3", "w4", "y1", "a", "y2", "dz1")
# csrc/sepconv_bwd.cu: SepPlan, field by field
C_FIELDS = ("B", "T", "H", "W", "C", "F", "tc", "is_bf16", "bn_f", "bn_c",
            "wbm_t", "wbn_t", "splits_t", "rps_t", "wbm_s", "wbn_s", "splits_s", "rps_s",
            "ew_rows", "mtiles") + tuple(f"o_{n}" for n in F32_BUFFERS) + tuple(
                f"o_{n}" for n in ACT_BUFFERS)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Product(NamedTuple):
    """One product of a call as an implicit GEMM.  Conv products (P1-P3,
    P5): ``m`` output rows by ``n`` channels, reduced over ``taps`` x ``k``
    input channels.  Weight products (P4, P6): ``m`` = ``k`` input channels
    by ``n`` channels per tap, reduced over the rows in ``splits`` row
    ranges of ``rows_per_split``."""
    name: str
    wgrad: bool
    m: int
    n: int
    k: int
    taps: int
    tile: Tuple[int, int, int]   # (BM, BN, BK): BK channels (conv) or rows (wgrad)
    stages: int
    threads: int
    smem_bytes: int
    grid: Tuple[int, ...]
    splits: int = 1
    rows_per_split: int = 0
    shared_taps: int = 1     # wgrad: taps of a block that share one staged D tile
    halo: int = 0            # spatial conv: rows staged on either side of a block's rows


class Plan(NamedTuple):
    """The launch of one call (``csrc/sepconv_bwd.cu``)."""
    route: str                   # "tc" or "simt"
    shape: Tuple[int, ...]       # (B, T, H, W, C, F)
    is_bf16: bool
    rows: int
    mtiles: int                  # row tiles of the conv products
    ew_rows: int                 # tc: rows per step of the elementwise pass
    products: Tuple[Product, ...]
    f32_offsets: Tuple[int, ...]   # F32_BUFFERS, in fp32 elements
    f32_sizes: Tuple[int, ...]
    act_offsets: Tuple[int, ...]   # ACT_BUFFERS, in compute-dtype elements
    act_sizes: Tuple[int, ...]

    def product(self, name: str) -> Product:
        return self.products[PRODUCTS.index(name)]

    @property
    def f32_size(self) -> int:
        return self.f32_offsets[-1] + self.f32_sizes[-1]

    @property
    def act_size(self) -> int:
        return self.act_offsets[-1] + self.act_sizes[-1]

    def c_fields(self) -> Tuple[int, ...]:
        b, t, h, w, c, f = self.shape
        p1, p4, p5, p6 = (self.product(n) for n in ("P1 y1", "P4 dWt", "P5 dx", "P6 dWs"))
        return (b, t, h, w, c, f, int(self.route == "tc"), int(self.is_bf16),
                p1.tile[1], p5.tile[1], p4.tile[0], p4.tile[1], p4.splits,
                p4.rows_per_split, p6.tile[0], p6.tile[1], p6.splits, p6.rows_per_split,
                self.ew_rows, self.mtiles) + self.f32_offsets + self.act_offsets


def route(c: int, f: int, dtype: torch.dtype) -> str:
    """``tc`` for bf16 with C and F multiples of 8 (16-byte rows for
    cp.async and the 16-byte elementwise pass), else ``simt``."""
    return "tc" if dtype == torch.bfloat16 and c % 8 == 0 and f % 8 == 0 else "simt"


def wgrad_splits(rows: int, taps: int, k: int, n: int) -> int:
    """Row splits of a simt weight-gradient product: about
    ``_WGRAD_BLOCKS`` blocks in all, at least 256 rows each."""
    tiles = taps * _cdiv(k, 64) * _cdiv(n, 64)
    want = _cdiv(_WGRAD_BLOCKS, tiles)
    return max(1, min(want, _MAX_SPLITS, _cdiv(rows, 256)))


def _tc_conv_bn(n: int, mtiles: int) -> int:
    """Block width of a tc conv product with N = ``n``: the least padded
    columns per unit of the width's speed (``_TC_BN_RATE``), ties to the
    wider tile; narrower while the grid has fewer blocks than SMs."""
    bn = min(TC_BN, key=lambda b: (_cdiv(n, b) * b / _TC_BN_RATE[b], -b))
    while bn > 32 and mtiles * _cdiv(n, bn) < SMS:
        bn //= 2
    return bn


def _split_rows(rows: int, splits: int, align: int) -> Tuple[int, int]:
    """(splits, rows per split): a multiple of ``align`` rows each, no split
    empty."""
    rps = _cdiv(_cdiv(rows, splits), align) * align
    return _cdiv(rows, rps), rps


def _halo_smem(w: int, bn: int) -> int:
    """Shared memory of a spatial tc product: 2 stages of the rows with their
    halo ([128 + 2 (W + 1)][24]) and the nine taps' [16][BN + 8] tiles."""
    rows = TC_BM + 2 * (w + 1)
    return TC_HALO_STAGES * (rows * (TC_HALO_BK + _PAD) + 9 * TC_HALO_BK * (bn + _PAD)) * 2


def _conv(name, rows, k, n, taps, route_, mtiles, w) -> Product:
    if route_ == "tc":
        bn = _tc_conv_bn(n, mtiles)
        if taps == 9:   # spatial: the halo ring
            while _halo_smem(w, bn) > MAX_SMEM_BYTES and bn > TC_BN[-1]:
                bn //= 2
            smem = _halo_smem(w, bn)
            if smem > MAX_SMEM_BYTES:
                raise ValueError(f"sepconv_bwd: a frame {w} wide needs {smem} bytes of "
                                 f"shared memory per block, above {MAX_SMEM_BYTES}")
            return Product(name, False, rows, n, k, taps, (TC_BM, bn, TC_HALO_BK),
                           TC_HALO_STAGES, TC_CONV_THREADS, smem, (mtiles, _cdiv(n, bn)),
                           halo=w + 1)
        # temporal: the per-tap ring and the epilogue's input tile
        smem = (TC_CONV_STAGES * (TC_BM * (TC_BK + _PAD) + TC_BK * (bn + _PAD))
                + TC_BM * (bn + _PAD)) * 2
        return Product(name, False, rows, n, k, taps, (TC_BM, bn, TC_BK), TC_CONV_STAGES,
                       TC_CONV_THREADS, smem, (mtiles, _cdiv(n, bn)))
    bm, bn, bk = SIMT_TILE
    smem = (bk * (bm + 4) + bk * (bn + 4)) * 4 + 2 * 16 * bn * 4
    return Product(name, False, rows, n, k, taps, SIMT_TILE, 1, SIMT_THREADS, smem,
                   (mtiles, _cdiv(n, bn)))


def _wgrad(name, rows, k, n, taps, route_) -> Product:
    if route_ == "tc":
        wbm, wbn = (min(t for t in TC_WG_TILES if t >= min(d, TC_WG_TILES[-1]))
                    for d in (k, n))
        tiles = taps // TC_SHARED_TAPS * _cdiv(k, wbm) * _cdiv(n, wbn)
        want = max(1, _TC_WGRAD_WAVES * TC_WGRAD_WAVE // tiles)   # no partial last wave
        splits, rps = _split_rows(
            rows, max(1, min(want, _TC_MAX_SPLITS, _cdiv(rows, TC_MIN_SPLIT_ROWS))), TC_BK)
        smem = TC_WGRAD_STAGES * TC_BK * (TC_SHARED_TAPS * (wbm + _PAD) + (wbn + _PAD)) * 2
        return Product(name, True, k, n, rows, taps, (wbm, wbn, TC_BK), TC_WGRAD_STAGES,
                       TC_WGRAD_THREADS, smem, (tiles, splits), splits, rps, TC_SHARED_TAPS)
    bm, bn, bk = SIMT_TILE
    splits, rps = _split_rows(rows, wgrad_splits(rows, taps, k, n), bk)
    smem = (bk * (bm + 4) + bk * (bn + 4)) * 4
    return Product(name, True, k, n, rows, taps, SIMT_TILE, 1, SIMT_THREADS, smem,
                   (_cdiv(k, bm), _cdiv(n, bn), taps * splits), splits, rps)


def _carve(sizes: Sequence[int], align: int) -> Tuple[int, ...]:
    offsets, at = [], 0
    for s in sizes:
        offsets.append(at)
        at += _cdiv(s, align) * align
    return tuple(offsets)


def plan(b: int, t: int, h: int, w: int, c: int, f: int, dtype: torch.dtype) -> Plan:
    """The launch of one call for x (B, T, H, W, C) -> F channels in the
    compute ``dtype``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sepconv_bwd: compute dtype {dtype} (want fp32 or bf16)")
    if 18 * c * f + 6 * f * f + 8 * f >= 2 ** 31:   # sep_prep_kernel's 32-bit index
        raise ValueError(f"sepconv_bwd: {c} -> {f} channels are too many")
    rt = route(c, f, dtype)
    rows = b * t * h * w
    mtiles = _cdiv(rows, TC_BM if rt == "tc" else SIMT_TILE[0])
    products = (_conv("P1 y1", rows, c, f, 9, rt, mtiles, w),
                _conv("P2 y2", rows, f, f, 3, rt, mtiles, w),
                _conv("P3 da", rows, f, f, 3, rt, mtiles, w),
                _wgrad("P4 dWt", rows, f, f, 3, rt),
                _conv("P5 dx", rows, f, c, 9, rt, mtiles, w),
                _wgrad("P6 dWs", rows, c, f, 9, rt))
    p4, p6 = products[3], products[5]
    wpart = max(p4.splits * 3 * f * f, p6.splits * 9 * c * f)
    f32_sizes = (9 * c * f, 3 * f * f, 4 * f, 4 * f, 4 * f, 2 * f, 2 * f,
                 mtiles * 2 * f, wpart)
    act_sizes = (9 * c * f, 3 * f * f, 3 * f * f, 9 * c * f) + (rows * f,) * 4
    ew_rows = max(1, min(rows, _EW_THREADS // max(1, f // 8))) if rt == "tc" else 0
    return Plan(rt, (b, t, h, w, c, f), dtype == torch.bfloat16, rows, mtiles, ew_rows,
                products, _carve(f32_sizes, 32), f32_sizes, _carve(act_sizes, 64),
                act_sizes)


def k_chunks(p: Product):
    """The K chunks of a product in the kernel's order.  Conv: (tap, first
    channel, end channel) per chunk, channels past ``k`` being the
    zero-filled tail; a spatial tc product runs the nine taps on each staged
    channel chunk.  Weight products: (split, first row, end row)."""
    bk = p.tile[2]
    if p.halo:
        for c0 in range(0, p.k, bk):
            for j in range(p.taps):
                yield j, c0, min(c0 + bk, p.k)
        return
    if p.wgrad:
        for s in range(p.splits):
            r0 = s * p.rows_per_split
            r1 = min(p.k, r0 + p.rows_per_split)
            for c0 in range(r0, r1, bk):
                yield s, c0, min(c0 + bk, r1)
        return
    for j in range(p.taps):
        for c0 in range(0, p.k, bk):
            yield j, c0, min(c0 + bk, p.k)


@functools.lru_cache(maxsize=256)
def _cached_plan(b, t, h, w, c, f, dtype):
    p = plan(b, t, h, w, c, f, dtype)
    fields = p.c_fields()
    return p, (ctypes.c_longlong * len(fields))(*fields)


# --------------------------------------------------------------------------- #
# the products' index maps in plain PyTorch (tests only)

def spatial_taps(sign: int):
    """(dt, dh, dw) of the 1x3x3 conv's taps, j = kh * 3 + kw; sign -1 for
    its transpose."""
    return [(0, sign * (kh - 1), sign * (kw - 1)) for kh in range(3) for kw in range(3)]


def temporal_taps(sign: int):
    """(dt, dh, dw) of the 3x1x1 conv's taps, j = kt; sign -1 for its
    transpose."""
    return [(sign * (k - 1), 0, 0) for k in range(3)]


def weight_layouts(ws: torch.Tensor, wt: torch.Tensor):
    """w1 [9][C][F], w2 [3][F'][F], w3 [3][F][F'], w4 [9][F][C] from ws
    (F, C, 1, 3, 3) and wt (F, F', 3, 1, 1), as ``sep_prep_kernel`` lays
    them out."""
    f, c = ws.shape[:2]
    wsc = ws[:, :, 0].reshape(f, c, 9)        # [f][c][j]
    wtc = wt[:, :, :, 0, 0]                   # [f][f'][k]
    return (wsc.permute(2, 1, 0), wtc.permute(2, 1, 0), wtc.permute(2, 0, 1),
            wsc.permute(2, 0, 1))


def _shifted(a: torch.Tensor, tap) -> torch.Tensor:
    """a (B, T, H, W, K) read at (t + dt, h + dh, w + dw), zero outside the
    clip."""
    dt, dh, dw = tap
    _, t, h, w, _ = a.shape
    ap = F.pad(a, (0, 0, 1, 1, 1, 1, 1, 1))
    return ap[:, 1 + dt:1 + dt + t, 1 + dh:1 + dh + h, 1 + dw:1 + dw + w]


def tap_gemm(a: torch.Tensor, wk: torch.Tensor, taps) -> torch.Tensor:
    """out[r, n] = sum_j sum_k a[shift_j(r), k] wk[j, k, n] for a (B, T, H,
    W, K): the conv products."""
    return sum(_shifted(a, tap) @ wk[j] for j, tap in enumerate(taps))


def tap_wgrad(a: torch.Tensor, d: torch.Tensor, taps) -> torch.Tensor:
    """dw[j, k, n] = sum_r a[shift_j(r), k] d[r, n] for a (B, T, H, W, K)
    and d (B, T, H, W, N): the weight products, [taps][K][N]."""
    k, n = a.shape[-1], d.shape[-1]
    dr = d.reshape(-1, n)
    return torch.stack([_shifted(a, tap).reshape(-1, k).T @ dr for tap in taps])


def wgrad_to_torch(dw: torch.Tensor) -> torch.Tensor:
    """[taps][K][N] -> (N, K, taps), the layout ``split_sum_kernel`` writes:
    out[(n * K + k) * taps + j]."""
    return dw.permute(2, 1, 0)


# --------------------------------------------------------------------------- #

def vector_loads(g: torch.Tensor) -> bool:
    """Whether the tc route may read the cotangent g (B, F, T, H, W) 16
    bytes at a time: contiguous channels, 16-byte aligned rows and start.
    The kernel reads g at any strides (a channel slice of an Inception
    concat's gradient, channels_last_3d below the next block's
    convolutions, (B, T, C, H, W) below the head's mean); other layouts are
    read channel by channel."""
    esize = g.element_size()
    rows_aligned = all((st * esize) % 16 == 0 for i, st in enumerate(g.stride())
                       if i != 1 and g.shape[i] > 1)
    return (g.stride(1) == 1 or g.shape[1] == 1) and rows_aligned and g.data_ptr() % 16 == 0


def _check(x, ws, wt, g, dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sepconv_bwd: compute dtype {dtype} (want fp32 or bf16)")
    if x.dim() != 5 or g.dim() != 5:
        raise ValueError(f"sepconv_bwd: x {tuple(x.shape)} and g {tuple(g.shape)} "
                         "must be (B, C, T, H, W)")
    b, c, t, h, w = x.shape
    f = ws.shape[0]
    if (tuple(ws.shape) != (f, c, 1, 3, 3) or tuple(wt.shape) != (f, f, 3, 1, 1)
            or tuple(g.shape) != (b, f, t, h, w)):
        raise ValueError(f"sepconv_bwd: ws {tuple(ws.shape)}, wt {tuple(wt.shape)}, "
                         f"g {tuple(g.shape)} do not fit x {tuple(x.shape)}")
    if not all(v.is_cuda and v.device == x.device for v in (x, ws, wt, g)):
        raise ValueError("sepconv_bwd: x, g and the weights must be on one CUDA device")


def _f32(v: torch.Tensor) -> torch.Tensor:
    return v if v.dtype == torch.float32 and v.is_contiguous() else v.float().contiguous()


def _as(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return v if v.dtype == dtype else v.to(dtype)


@functools.cache
def _check_fields() -> None:
    n = _build.library().vgs_sepconv_plan_fields()
    if n != len(C_FIELDS):
        raise RuntimeError(f"sepconv_bwd: the library's plan has {n} fields, the "
                           f"wrapper {len(C_FIELDS)}")


class _Call(NamedTuple):
    """One call's plan, operands and buffers: ``head`` are the C entries'
    arguments up to the f32 scratch, ``tail`` those after dx up to eps."""
    plan: Plan
    head: tuple
    tail: tuple
    buf: torch.Tensor      # fp32 scratch
    act: torch.Tensor      # compute-dtype scratch
    dx: torch.Tensor
    keep: tuple            # operands that must outlive the launches


def _setup(x, ws, wt, g1, b1, g2, b2, mu1, var1, mu2, var2, g, dtype) -> _Call:
    global g_copies
    _check(x, ws, wt, g, dtype)
    b, c, t, h, w = x.shape
    f = ws.shape[0]
    p, c_plan = _cached_plan(b, t, h, w, c, f, dtype)
    dev = x.device
    xc = _as(x, dtype).contiguous(memory_format=_CL)
    if p.route == "tc" and xc.data_ptr() % 16:
        xc = xc.clone(memory_format=_CL)
    if g.dtype != dtype:
        g_copies += 1
    gc = _as(g, dtype)
    params = [_f32(v) for v in (ws, wt, g1, b1, g2, b2, mu1, var1, mu2, var2)]
    buf = torch.empty(p.f32_size, dtype=torch.float32, device=dev)
    act = torch.empty(p.act_size, dtype=dtype, device=dev)
    dx = torch.empty((b, c, t, h, w), dtype=dtype, device=dev, memory_format=_CL)
    _check_fields()
    head = (xc.data_ptr(), gc.data_ptr(), *(v.data_ptr() for v in params), buf.data_ptr())
    tail = (c_plan, *gc.stride(), int(vector_loads(gc)), fused_sepconv.EPS)
    return _Call(p, head, tail, buf, act, dx, (xc, gc, params))


def _outputs(call: _Call, out: torch.Tensor, x, ws, wt, g1, b1, g2, b2):
    """(dx, dWs, dWt, dgamma1, dbeta1, dgamma2, dbeta2) from the call's dx
    and its fp32 outputs ``out`` (dWs, dWt and the BN sums at the plan's
    offsets)."""
    b, c, t, h, w = x.shape
    f = ws.shape[0]
    o_ws, o_wt, o_s = call.plan.f32_offsets[:3]   # dws, dwt, sums: S_g1, S_gx1, S_g2, S_gx2
    dws = out.as_strided((f, c, 1, 3, 3), (9 * c, 9, 9, 3, 1), o_ws)
    dwt = out.as_strided((f, f, 3, 1, 1), (3 * f, 3, 1, 1, 1), o_wt)
    s_g1, s_gx1, s_g2, s_gx2 = out.as_strided((4, f), (f, 1), o_s).unbind(0)
    return (_as(call.dx, x.dtype), _as(dws, ws.dtype), _as(dwt, wt.dtype),
            _as(s_gx1, g1.dtype), _as(s_g1, b1.dtype), _as(s_gx2, g2.dtype),
            _as(s_g2, b2.dtype))


def sepconv_bwd(x, ws, wt, g1, b1, g2, b2, mu1, var1, mu2, var2, g, dtype,
                count: Optional[torch.Tensor] = None,
                reduce: Optional[Callable[[torch.Tensor], None]] = None):
    """One kernel call, its three stages in turn: (dx, dWs, dWt, dgamma1,
    dbeta1, dgamma2, dbeta2).

    ``reduce`` (ranks that each hold rows of one batch, with ``count`` the
    global row count, an fp32 CUDA tensor whose first element is read):
    sums a [2][F] fp32 tensor over the ranks in place, on the current
    stream.  Between stages 1 and 2 it takes a copy of S_g2, S_gx2, between
    2 and 3 of S_g1, S_gx1, and the next stage's BN backward uses their
    means over the global batch.  The returned dgamma and dbeta stay this
    rank's own sums (``DistributedDataParallel`` averages them, as
    ``parallel/sync_bn.py`` leaves them).  Without ``reduce`` the stages
    launch the kernels of :func:`sepconv_bwd_one_call`, in its order."""
    global launches, launches_tc, stage_calls, reduces
    if (reduce is None) != (count is None):
        raise ValueError("sepconv_bwd: reduce and count go together")
    call = _setup(x, ws, wt, g1, b1, g2, b2, mu1, var1, mu2, var2, g, dtype)
    p = call.plan
    f = ws.shape[0]
    # dWs, dWt and the BN sums in a buffer of their own, so the scratch is
    # freed when the call returns
    out = torch.empty(p.f32_offsets[3], dtype=torch.float32, device=x.device)
    sums = out[p.f32_offsets[2]:p.f32_offsets[2] + 4 * f].view(4, f)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.library()
    entries = (lib.vgs_sepconv_bwd_stage1, lib.vgs_sepconv_bwd_stage2,
               lib.vgs_sepconv_bwd_stage3)
    reduced = None
    for stage, entry in enumerate(entries, 1):
        if reduce is not None and stage > 1:
            # stage 2 takes S_g2, S_gx2 over every rank, stage 3 S_g1, S_gx1
            reduced = sums[2:4].clone() if stage == 2 else sums[0:2].clone()
            reduce(reduced)
            reduces += 1
        code = entry(*call.head, out.data_ptr(), call.act.data_ptr(), call.dx.data_ptr(),
                     *call.tail, 0 if reduced is None else reduced.data_ptr(),
                     0 if count is None else count.data_ptr(), stream)
        _build.check(code, f"vgs_sepconv_bwd_stage{stage}")
        stage_calls += 1
    launches += 1
    launches_tc += p.route == "tc"
    return _outputs(call, out, x, ws, wt, g1, b1, g2, b2)


def sepconv_bwd_one_call(x, ws, wt, g1, b1, g2, b2, mu1, var1, mu2, var2, g, dtype):
    """The same function through the one C entry that runs all three
    stages with no reduce between them (``vgs_sepconv_bwd``): the staged
    call on one process must equal it bit for bit (``chip_smoke.py``)."""
    global launches, launches_tc
    call = _setup(x, ws, wt, g1, b1, g2, b2, mu1, var1, mu2, var2, g, dtype)
    code = _build.library().vgs_sepconv_bwd(
        *call.head, call.act.data_ptr(), call.dx.data_ptr(), *call.tail,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "vgs_sepconv_bwd")
    launches += 1
    launches_tc += call.plan.route == "tc"
    return _outputs(call, call.buf, x, ws, wt, g1, b1, g2, b2)
