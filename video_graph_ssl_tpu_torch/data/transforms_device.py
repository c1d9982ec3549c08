"""On-device augmentation (counterpart of
``video_graph_ssl_tpu/data/transforms_device.py``): the SSL chain (the
channel-first ``ssl_augment_cf``, ``make_batch_augment_fn(cfg, 'ssl')``),
the downstream ``train`` chain (MultiScaleCrop, flip, normalise), the
``eval`` chain (resize, centre crop, normalise) and the test-time
``multi_crop_eval``.

The random parameters are drawn apart from their application
(:func:`draw_ssl_params` / :func:`apply_ssl_augment`), so a test can feed
both packages the same crop boxes, factors, flags and jitter orders.  A
rank that holds rows of a global batch draws the parameters of the whole
global batch, as one process would, and applies its rows
(:meth:`SSLParams.rows`): the jitter order of a clip-view is that of its
group in the global batch.

Chain per clip-view, on (T, C, H, W) pixels in [0, 255]: RandomResizedCrop
(bilinear, no antialias, the weights of ``jax.image.scale_and_translate``),
colour jitter in one of the 24 op orders (one order per group of clips, as
in the JAX package), grayscale, separable Gaussian blur, horizontal flip,
normalise.  Works on the clips' device in the compute dtype.

The downstream chains work on (N, T, H, W, C) float32 pixels, as the JAX
ones do, and return float32.  The ``train`` chain's draws (a MultiScaleCrop
size pair and one of 13 offsets, a flip) are likewise apart from their
application (:func:`draw_train_params` / :func:`apply_train_augment`), and
a rank applies its rows of the global batch's draws
(:meth:`TrainParams.rows`).
Every resize is an explicit weight matrix per axis
(:func:`resize_weights`): the crop's bilinear resize without antialias
(``jax.image.scale_and_translate``), and ``resize_clip``'s linear resize
with antialias, as ``jax.image.resize`` defaults to (a triangle kernel
widened by the down-scale factor).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

JITTER_PERMS: Tuple[Tuple[int, ...], ...] = tuple(itertools.permutations(range(4)))
_LUMA = (0.299, 0.587, 0.114)
_F32_EPS = float(torch.finfo(torch.float32).eps)


@dataclass
class SSLParams:
    """Per clip-view (N = B * V) draws, plus one jitter order per group.

    ``row0`` and ``group_rows`` place the N clip-views in a larger draw:
    they are its rows ``[row0, row0 + N)``, and its jitter groups hold
    ``group_rows`` rows each (0: the N rows form the ``len(perm_ids)``
    groups themselves)."""

    box: torch.Tensor       # (N, 4) int64: crop top, left, height, width
    fb: torch.Tensor        # (N,) brightness factor
    fc: torch.Tensor        # (N,) contrast factor
    fs: torch.Tensor        # (N,) saturation factor
    fh: torch.Tensor        # (N,) hue shift
    jitter: torch.Tensor    # (N,) bool: apply the colour jitter
    gray: torch.Tensor      # (N,) bool
    sigma: torch.Tensor     # (N,) blur sigma
    blur: torch.Tensor      # (N,) bool
    flip: torch.Tensor      # (N,) bool
    perm_ids: torch.Tensor  # (G,) int64 index into JITTER_PERMS
    row0: int = 0
    group_rows: int = 0

    def rows(self, lo: int, hi: int) -> "SSLParams":
        """The draws of clip-views ``[lo, hi)``, with every group's order."""
        n = self.box.shape[0]
        if not 0 <= lo < hi <= n:
            raise ValueError(f"rows [{lo}, {hi}) outside {n} clip-views")
        per = {f: getattr(self, f)[lo:hi] for f in
               ("box", "fb", "fc", "fs", "fh", "jitter", "gray", "sigma", "blur", "flip")}
        return SSLParams(**per, perm_ids=self.perm_ids, row0=self.row0 + lo,
                         group_rows=self.group_rows or n // len(self.perm_ids))


def n_jitter_groups(n: int) -> int:
    return next(g for g in (8, 4, 2, 1) if n % g == 0)


def draw_ssl_params(n: int, canvas_hw: Tuple[int, int], generator: torch.Generator,
                    device, flip_p: float = 0.5, rrc_scale=(0.2, 1.0),
                    ratio=(3.0 / 4.0, 4.0 / 3.0), attempts: int = 10,
                    jitter_p: float = 0.8, gray_p: float = 0.2,
                    blur_p: float = 0.5, brightness: float = 0.4,
                    contrast: float = 0.4, saturation: float = 0.4,
                    hue: float = 0.1, sigma_limit=(0.1, 2.0)) -> SSLParams:
    """Draw the chain's parameters for ``n`` clip-views on ``device``."""
    H, W = canvas_hw

    def U(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (hi - lo) + lo

    # RandomResizedCrop: first valid of `attempts` (area, ratio) draws, else
    # the centre crop at the clamped ratio (torchvision semantics).
    target = U((n, attempts), *rrc_scale) * float(H * W)
    aspect = torch.exp(U((n, attempts), math.log(ratio[0]), math.log(ratio[1])))
    ws = torch.round(torch.sqrt(target * aspect)).long()
    hs = torch.round(torch.sqrt(target / aspect)).long()
    valid = (ws > 0) & (ws <= W) & (hs > 0) & (hs <= H)
    first = valid.int().argmax(dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    w_sel = ws.gather(1, first)[:, 0]
    h_sel = hs.gather(1, first)[:, 0]
    u_i = U((n, attempts)).gather(1, first)[:, 0]
    u_j = U((n, attempts)).gather(1, first)[:, 0]
    i_sel = torch.floor(u_i * (H - h_sel + 1).float()).long()
    j_sel = torch.floor(u_j * (W - w_sel + 1).float()).long()
    in_ratio = float(W) / float(H)
    if in_ratio < ratio[0]:
        fw, fh_ = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        fh_, fw = H, int(round(H * ratio[1]))
    else:
        fw, fh_ = W, H
    fallback = torch.tensor([(H - fh_) // 2, (W - fw) // 2, fh_, fw], device=device)
    box = torch.stack([i_sel, j_sel, h_sel, w_sel], dim=1)
    box = torch.where(any_valid[:, None], box, fallback[None])

    return SSLParams(
        box=box,
        fb=U(n, 1 - brightness, 1 + brightness),
        fc=U(n, 1 - contrast, 1 + contrast),
        fs=U(n, 1 - saturation, 1 + saturation),
        fh=U(n, -hue, hue),
        jitter=U(n) < jitter_p,
        gray=U(n) < gray_p,
        sigma=U(n, *sigma_limit),
        blur=U(n) < blur_p,
        flip=U(n) < flip_p,
        perm_ids=torch.randint(0, len(JITTER_PERMS), (n_jitter_groups(n),),
                               generator=generator, device=device),
    )


def resize_weights(in_size: int, out_size: int, start: torch.Tensor,
                   length: torch.Tensor, antialias: bool = False) -> torch.Tensor:
    """(N, out, in) fp32 linear-interpolation weights that map the window
    [start, start + length) of an axis onto ``out_size`` samples -- the
    weight matrix of ``jax.image.scale_and_translate(method='linear',
    antialias=...)`` with scale out/length and translation -start*scale.
    With ``antialias`` a down-scale widens the triangle kernel by
    length/out (``jax.image.resize``'s default)."""
    dev = start.device
    length = length.float()
    # a true division (a Python scalar over a tensor is its reciprocal times
    # the scalar in torch, which rounds twice)
    scale = torch.full_like(length, float(out_size)) / length
    trans = -start.float() * scale
    inv = 1.0 / scale
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample_f = (o[None] + 0.5) * inv[:, None] - (trans * inv)[:, None] - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=dev)
    dist = (sample_f[:, None, :] - src[None, :, None]).abs()
    if antialias:
        dist = dist / inv.clamp_min(1.0)[:, None, None]
    w = (1.0 - dist).clamp_min(0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = w * inside[:, None, :]
    return w.transpose(1, 2)


def _bc(v: torch.Tensor) -> torch.Tensor:
    """(N,) -> (N, 1, 1, 1, 1) for (N, T, C, H, W) clips."""
    return v.reshape(-1, 1, 1, 1, 1)


def _gray(x: torch.Tensor, keep_channels: bool = True) -> torch.Tensor:
    g = (_LUMA[0] * x[:, :, 0] + _LUMA[1] * x[:, :, 1]
         + _LUMA[2] * x[:, :, 2])[:, :, None]
    return g.expand_as(x) if keep_channels else g


def _brightness(x, f):
    return (x.float() * f).clamp(0.0, 255.0).to(x.dtype)


def _contrast(x, f):
    mean = _gray(x, False).float().mean(dim=(-3, -2, -1), keepdim=True)
    return (x.float() * f + (mean * (1.0 - f)).to(x.dtype).float()
            ).clamp(0.0, 255.0).to(x.dtype)


def _saturation(x, f):
    return (x.float() * f + _gray(x).float() * (1.0 - f)
            ).clamp(0.0, 255.0).to(x.dtype)


def _hue(x, shift):
    """HSV hue shift in u = 6h units (one reciprocal, two wrap selects)."""
    r, g, b = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    inv = 1.0 / d.clamp_min(1e-6)
    u = torch.where(r == mx, (g - b) * inv,
                    torch.where(g == mx, 2.0 + (b - r) * inv, 4.0 + (r - g) * inv))
    u = u.float() + 6.0 * shift[:, :, 0]
    u = torch.where(u < 0.0, u + 6.0, u)
    u = torch.where(u >= 6.0, u - 6.0, u)
    i = torch.floor(u)
    f = u - i
    mxf, df = mx.float(), d.float()
    p, q, t = mxf - df, mxf - df * f, mxf - df * (1.0 - f)
    i = i.int()

    def sel(c0, c1, c2, c3, c4, c5):
        return torch.where(i == 0, c0, torch.where(i == 1, c1, torch.where(
            i == 2, c2, torch.where(i == 3, c3, torch.where(i == 4, c4, c5)))))

    rgb = torch.stack([sel(mxf, q, p, p, t, mxf), sel(t, mxf, mxf, q, p, p),
                       sel(p, p, t, mxf, mxf, q)], dim=2)
    return rgb.to(x.dtype)


def _jitter_chain(perm: Sequence[int], x, fb, fc, fs, fh):
    ops = {0: lambda c: _brightness(c, fb), 1: lambda c: _contrast(c, fc),
           2: lambda c: _saturation(c, fs), 3: lambda c: _hue(c, fh)}
    for o in perm:
        x = ops[o](x)
    return x


def blur_matrix(size: int, sigma: torch.Tensor, kernel_size: int = 13) -> torch.Tensor:
    """(N, size, size) banded matrices == zero-padded SAME Gaussian conv."""
    r = kernel_size // 2
    ar = torch.arange(size, device=sigma.device)
    d = (ar[:, None] - ar[None, :]).float()
    s2 = (2.0 * sigma.float() ** 2)[:, None, None]
    w = torch.exp(-(d ** 2)[None] / s2)
    w = torch.where(d.abs()[None] <= r, w, torch.zeros_like(w))
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=sigma.device)
    norm = torch.exp(-(xs ** 2)[None] / s2[:, :, 0]).sum(dim=1)
    return w / norm[:, None, None]


def _blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    bw = blur_matrix(w, sigma).to(x.dtype)
    bh = blur_matrix(h, sigma).to(x.dtype)
    x = torch.einsum("ntchw,nwk->ntchk", x, bw)
    return torch.einsum("ntchw,nhk->ntckw", x, bh)


def apply_ssl_augment(clips: torch.Tensor, p: SSLParams, out_hw: Tuple[int, int],
                      mean: Sequence[float], std: Sequence[float],
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, V, T, H, W, 3) uint8 (or float pixels) -> (B, V, T, oh, ow, 3) in
    ``dtype``, normalised."""
    b, v, t, H, W, c = clips.shape
    if c != 3:
        raise NotImplementedError("the SSL chain is ported for RGB clips only")
    n = b * v
    oh, ow = out_hw
    x = clips.reshape(n, t, H, W, c).permute(0, 1, 4, 2, 3).to(dtype)
    top, left, hh, ww = p.box.unbind(1)
    wy = resize_weights(H, oh, top, hh).to(dtype)
    wx = resize_weights(W, ow, left, ww).to(dtype)
    x = torch.einsum("nyh,ntchw->ntcyw", wy, x)
    x = torch.einsum("nxw,ntcyw->ntcyx", wx, x)

    groups = p.perm_ids.tolist()
    per = p.group_rows or n // len(groups)
    spans = [(max(g * per - p.row0, 0), min((g + 1) * per - p.row0, n), pid)
             for g, pid in enumerate(groups)]
    jittered = torch.cat([
        _jitter_chain(JITTER_PERMS[pid], x[lo:hi],
                      *(_bc(f[lo:hi]) for f in (p.fb, p.fc, p.fs, p.fh)))
        for lo, hi, pid in spans if lo < hi])
    x = torch.where(_bc(p.jitter), jittered, x)
    x = torch.where(_bc(p.gray), _gray(x), x)
    x = torch.where(_bc(p.blur), _blur(x, p.sigma), x)
    x = torch.where(_bc(p.flip), x.flip(-1), x)
    m = torch.tensor(mean, dtype=torch.float32, device=x.device).reshape(1, 1, c, 1, 1) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device).reshape(1, 1, c, 1, 1) * 255.0
    x = ((x.float() - m) / s).to(dtype)
    return x.permute(0, 1, 3, 4, 2).reshape(b, v, t, oh, ow, c)


# --------------------------------------------------------------------------- #
# downstream chains (N, T, H, W, C) float32
# --------------------------------------------------------------------------- #
MSC_SCALES = (1.0, 0.875, 0.75, 0.66)
# the TSN 13-position fixed-offset grid in quarters of the free room (w, h)
# (JAX ``_fix_offsets_13``)
FIX_OFFSETS_13 = ((0, 0), (4, 0), (0, 4), (4, 4), (2, 2), (0, 2), (4, 2), (2, 4), (2, 0),
                  (1, 1), (3, 1), (1, 3), (3, 3))


def msc_crop_pairs(H: int, W: int, input_size, scales=MSC_SCALES,
                   max_distort: int = 1):
    """The MultiScaleCrop (w, h) candidates (a copy of the JAX
    ``msc_crop_pairs``): the short side scaled, sizes within 3 px of the
    target snapped to it, pairs with |i - j| <= max_distort."""
    base = min(H, W)
    crop_sizes = [int(base * s) for s in scales]
    crop_h = [input_size[0] if abs(x - input_size[0]) < 3 else x for x in crop_sizes]
    crop_w = [input_size[1] if abs(x - input_size[1]) < 3 else x for x in crop_sizes]
    return [(w, h) for i, h in enumerate(crop_h) for j, w in enumerate(crop_w)
            if abs(i - j) <= max_distort]


@dataclass
class TrainParams:
    """Per-clip draws of the ``train`` chain."""

    pair: torch.Tensor     # (N,) int64 index into msc_crop_pairs
    offset: torch.Tensor   # (N,) int64 index into FIX_OFFSETS_13
    flip: torch.Tensor     # (N,) bool

    def rows(self, lo: int, hi: int) -> "TrainParams":
        """The draws of clips ``[lo, hi)``."""
        n = self.pair.shape[0]
        if not 0 <= lo < hi <= n:
            raise ValueError(f"rows [{lo}, {hi}) outside {n} clips")
        return TrainParams(self.pair[lo:hi], self.offset[lo:hi], self.flip[lo:hi])


def draw_train_params(n: int, generator: torch.Generator, device, n_pairs: int,
                      flip_p: float = 0.5) -> TrainParams:
    return TrainParams(
        pair=torch.randint(0, n_pairs, (n,), generator=generator, device=device),
        offset=torch.randint(0, len(FIX_OFFSETS_13), (n,), generator=generator,
                             device=device),
        flip=torch.rand(n, generator=generator, device=device) < flip_p)


def msc_boxes(p: TrainParams, canvas_hw: Tuple[int, int], pairs) -> torch.Tensor:
    """(N, 4) int64 (top, left, height, width): the crop of each draw, its
    offsets in float32 truncated to integers as the JAX chain's int32 cast."""
    H, W = canvas_hw
    dev = p.pair.device
    wh = torch.tensor(pairs, dtype=torch.float32, device=dev)[p.pair]      # (N, 2)
    grid = torch.tensor(FIX_OFFSETS_13, dtype=torch.float32, device=dev)[p.offset]
    room = torch.tensor([W, H], dtype=torch.float32, device=dev) - wh
    off = (grid * (room / 4.0)).long()                                   # (w, h)
    return torch.stack([off[:, 1], off[:, 0], wh[:, 1].long(), wh[:, 0].long()], dim=1)


def _normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """(x - 255 mean) / (255 std) over the trailing channel dim."""
    c = x.shape[-1]
    if len(mean) != c:
        raise NotImplementedError(f"{c}-channel clips: the chains are ported for RGB")
    m = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return (x - m) / s


def _resize_boxes(x: torch.Tensor, box: torch.Tensor, out_hw, antialias: bool = False):
    """(N, T, H, W, C) -> (N, T, oh, ow, C): each clip's box resized."""
    H, W = x.shape[2:4]
    top, left, hh, ww = box.unbind(1)
    wy = resize_weights(H, out_hw[0], top, hh, antialias)
    wx = resize_weights(W, out_hw[1], left, ww, antialias)
    x = torch.einsum("nyh,nthwc->ntywc", wy, x)
    return torch.einsum("nxw,ntywc->ntyxc", wx, x)


def apply_train_augment(clips: torch.Tensor, p: TrainParams, out_hw: Tuple[int, int],
                        mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """(N, T, H, W, C) uint8 -> (N, T, oh, ow, C) float32: MultiScaleCrop
    (bilinear, no antialias), horizontal flip, normalise (JAX
    ``train_augment``)."""
    H, W = clips.shape[2:4]
    pairs = msc_crop_pairs(H, W, out_hw)
    x = _resize_boxes(clips.float(), msc_boxes(p, (H, W), pairs), out_hw)
    x = torch.where(p.flip.reshape(-1, 1, 1, 1, 1), x.flip(3), x)
    return _normalize(x, mean, std)


def resize_clip(clips: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N, T, H, W, C) -> (N, T, oh, ow, C) float32: ``jax.image.resize``'s
    linear method, antialias on."""
    n, _, H, W = clips.shape[:4]
    box = torch.tensor([[0, 0, H, W]], device=clips.device).expand(n, 4)
    return _resize_boxes(clips.float(), box, out_hw, antialias=True)


def center_crop(clips: torch.Tensor, crop_hw: Tuple[int, int]) -> torch.Tensor:
    H, W = clips.shape[2:4]
    y, x = (H - crop_hw[0]) // 2, (W - crop_hw[1]) // 2
    return clips[:, :, y:y + crop_hw[0], x:x + crop_hw[1]]


def eval_transform(clips: torch.Tensor, scale_hw, crop_hw, mean, std) -> torch.Tensor:
    """The ``eval`` chain: resize, centre crop, normalise."""
    return _normalize(center_crop(resize_clip(clips, scale_hw), crop_hw), mean, std)


N_CROPS = (1, 3, 5, 6, 10)


def crop_offsets(scale_hw, crop_hw, n_crops: int):
    """(top, left) of each crop of ``multi_crop_eval`` before the flips."""
    H, W = scale_hw
    ch, cw = crop_hw
    if n_crops not in N_CROPS:
        raise ValueError(f"n_crops {n_crops}: one of {N_CROPS}")
    base = {1: 1, 3: 3, 5: 5, 6: 3, 10: 5}[n_crops]
    w4, h4 = (W - cw) // 4, (H - ch) // 4
    if base == 1:
        return [((H - ch) // 2, (W - cw) // 2)]
    if base == 3:
        return [(2 * h4, 0), (2 * h4, 4 * w4), (2 * h4, 2 * w4)]
    return [(0, 0), (0, 4 * w4), (4 * h4, 0), (4 * h4, 4 * w4), (2 * h4, 2 * w4)]


def multi_crop_eval(clips: torch.Tensor, scale_hw, crop_hw, n_crops: int,
                    mean, std) -> torch.Tensor:
    """(N, T, H, W, C) -> (N, n_crops, T, ch, cw, C) float32: resize, then
    1 centre | 3 full-height left/right/centre | 5 corners + centre crops,
    6 and 10 adding the 3 and 5 flipped (JAX ``multi_crop_eval``)."""
    x = resize_clip(clips, scale_hw)
    ch, cw = crop_hw
    crops = [x[:, :, oy:oy + ch, ox:ox + cw] for oy, ox in crop_offsets(scale_hw, crop_hw,
                                                                          n_crops)]
    if n_crops in (6, 10):
        crops += [c.flip(3) for c in crops]
    return _normalize(torch.stack(crops, dim=1), mean, std)


def make_batch_augment_fn(cfg, kind: str) -> Callable:
    """kind='ssl': fn(generator, clips (B, V, T, H, W, C) uint8, rows=None)
    -> the augmented, normalised clips in ``TPU.COMPUTE_DTYPE``.  ``rows``
    (row0, global B): the clips are rows ``[row0, row0 + B)`` of a global
    batch, and take those rows of the global batch's draws.

    kind='train': fn(generator, clips (B, T, H, W, C) uint8, rows=None) ->
    float32, the ``train`` chain to ``INPUT.BASE_SIZE``, ``rows`` as for
    'ssl'; kind='eval':
    fn(clips (B, T, H, W, C) uint8) -> float32, resized to
    ``INPUT.SCALE_SIZE`` and centre-cropped to ``INPUT.CROP_SIZE``."""
    if kind not in ("ssl", "train", "eval"):
        raise ValueError(f"unknown augment kind: {kind}")
    mean, std = tuple(cfg.INPUT.MEAN), tuple(cfg.INPUT.STD)
    out_hw = (int(cfg.INPUT.BASE_SIZE[0]), int(cfg.INPUT.BASE_SIZE[1]))
    flip_p = 0.5 if cfg.INPUT.FLIP else 0.0
    if kind == "eval":
        scale_hw = (int(cfg.INPUT.SCALE_SIZE[0]), int(cfg.INPUT.SCALE_SIZE[1]))
        crop_hw = (int(cfg.INPUT.CROP_SIZE[0]), int(cfg.INPUT.CROP_SIZE[1]))
        return lambda clips: eval_transform(clips, scale_hw, crop_hw, mean, std)
    if kind == "train":
        def train_fn(generator: torch.Generator, clips: torch.Tensor,
                     rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
            b, _, h, w = clips.shape[:4]
            row0, total = rows if rows is not None else (0, b)
            p = draw_train_params(total, generator, clips.device,
                                  len(msc_crop_pairs(h, w, out_hw)), flip_p)
            if total != b:
                p = p.rows(row0, row0 + b)
            return apply_train_augment(clips, p, out_hw, mean, std)

        return train_fn

    from ..models.build import compute_dtype

    dtype = compute_dtype(cfg)

    def fn(generator: torch.Generator, clips: torch.Tensor,
           rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        b, v, _, h, w = clips.shape[:5]
        row0, total = rows if rows is not None else (0, b)
        params = draw_ssl_params(total * v, (h, w), generator, clips.device,
                                 flip_p=flip_p)
        if total != b:
            params = params.rows(row0 * v, (row0 + b) * v)
        return apply_ssl_augment(clips, params, out_hw, mean, std, dtype)

    return fn
