"""On-device SSL augmentation (counterpart of the channel-first chain in
``video_graph_ssl_tpu/data/transforms_device.py``: ``ssl_augment_cf`` and
``make_batch_augment_fn(cfg, 'ssl')``).

The random parameters are drawn apart from their application
(:func:`draw_ssl_params` / :func:`apply_ssl_augment`), so a test can feed
both packages the same crop boxes, factors, flags and jitter orders.

Chain per clip-view, on (T, C, H, W) pixels in [0, 255]: RandomResizedCrop
(bilinear, no antialias, the weights of ``jax.image.scale_and_translate``),
colour jitter in one of the 24 op orders (one order per group of clips, as
in the JAX package), grayscale, separable Gaussian blur, horizontal flip,
normalise.  Works on the clips' device in the compute dtype.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

import torch

JITTER_PERMS: Tuple[Tuple[int, ...], ...] = tuple(itertools.permutations(range(4)))
_LUMA = (0.299, 0.587, 0.114)
_F32_EPS = float(torch.finfo(torch.float32).eps)


@dataclass
class SSLParams:
    """Per clip-view (N = B * V) draws, plus one jitter order per group."""

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
                   length: torch.Tensor) -> torch.Tensor:
    """(N, out, in) fp32 linear-interpolation weights that map the window
    [start, start + length) of an axis onto ``out_size`` samples -- the
    weight matrix of ``jax.image.scale_and_translate(method='linear',
    antialias=False)`` with scale out/length and translation -start*scale."""
    dev = start.device
    scale = float(out_size) / length.float()
    trans = -start.float() * scale
    inv = 1.0 / scale
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample_f = (o[None] + 0.5) * inv[:, None] - (trans * inv)[:, None] - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = (1.0 - (sample_f[:, None, :] - src[None, :, None]).abs()).clamp_min(0.0)
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
    per = n // len(groups)
    jittered = torch.cat([
        _jitter_chain(JITTER_PERMS[pid], x[g * per:(g + 1) * per],
                      *(_bc(f[g * per:(g + 1) * per]) for f in (p.fb, p.fc, p.fs, p.fh)))
        for g, pid in enumerate(groups)])
    x = torch.where(_bc(p.jitter), jittered, x)
    x = torch.where(_bc(p.gray), _gray(x), x)
    x = torch.where(_bc(p.blur), _blur(x, p.sigma), x)
    x = torch.where(_bc(p.flip), x.flip(-1), x)
    m = torch.tensor(mean, dtype=torch.float32, device=x.device).reshape(1, 1, c, 1, 1) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device).reshape(1, 1, c, 1, 1) * 255.0
    x = ((x.float() - m) / s).to(dtype)
    return x.permute(0, 1, 3, 4, 2).reshape(b, v, t, oh, ow, c)


def make_batch_augment_fn(cfg, kind: str) -> Callable:
    """kind='ssl': fn(generator, clips (B, V, T, H, W, C) uint8) -> the
    augmented, normalised clips in ``TPU.COMPUTE_DTYPE``."""
    if kind != "ssl":
        raise NotImplementedError(f"augment kind {kind!r} is not ported yet")
    from ..models.build import compute_dtype

    mean, std = tuple(cfg.INPUT.MEAN), tuple(cfg.INPUT.STD)
    out_hw = (int(cfg.INPUT.BASE_SIZE[0]), int(cfg.INPUT.BASE_SIZE[1]))
    flip_p = 0.5 if cfg.INPUT.FLIP else 0.0
    dtype = compute_dtype(cfg)

    def fn(generator: torch.Generator, clips: torch.Tensor) -> torch.Tensor:
        b, v, _, h, w = clips.shape[:5]
        params = draw_ssl_params(b * v, (h, w), generator, clips.device,
                                 flip_p=flip_p)
        return apply_ssl_augment(clips, params, out_hw, mean, std, dtype)

    return fn
