"""The SSL augmentation in plain float32, with the measured program's draws.

Per clip-view: RandomResizedCrop (bilinear, no antialias, the weights of
``jax.image.scale_and_translate``), colour jitter in one of the 24 op orders
(one order per group of clip-views), grayscale, separable Gaussian blur,
horizontal flip, normalisation.  The random parameters come from a
``torch.Generator`` in the same calls, shapes and order as the program
makes them, so one seed gives both sides the same crops, factors and
flags; they are applied here in float32.
"""

from __future__ import annotations

import itertools
import math

import torch

JITTER_PERMS = tuple(itertools.permutations(range(4)))
LUMA = (0.299, 0.587, 0.114)
F32_EPS = float(torch.finfo(torch.float32).eps)


def draw_params(n: int, canvas_hw, g: torch.Generator, device, flip_p: float = 0.5) -> dict:
    H, W = canvas_hw
    attempts, scale, ratio = 10, (0.2, 1.0), (3.0 / 4.0, 4.0 / 3.0)

    def U(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    target = U((n, attempts), *scale) * float(H * W)
    aspect = torch.exp(U((n, attempts), math.log(ratio[0]), math.log(ratio[1])))
    ws = torch.round(torch.sqrt(target * aspect)).long()
    hs = torch.round(torch.sqrt(target / aspect)).long()
    valid = (ws > 0) & (ws <= W) & (hs > 0) & (hs <= H)
    first = valid.int().argmax(dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    w_sel, h_sel = ws.gather(1, first)[:, 0], hs.gather(1, first)[:, 0]
    u_i = U((n, attempts)).gather(1, first)[:, 0]
    u_j = U((n, attempts)).gather(1, first)[:, 0]
    i_sel = torch.floor(u_i * (H - h_sel + 1).float()).long()
    j_sel = torch.floor(u_j * (W - w_sel + 1).float()).long()
    in_ratio = float(W) / float(H)
    if in_ratio < ratio[0]:
        fw, fh = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        fh, fw = H, int(round(H * ratio[1]))
    else:
        fw, fh = W, H
    fallback = torch.tensor([(H - fh) // 2, (W - fw) // 2, fh, fw], device=device)
    box = torch.where(any_valid[:, None], torch.stack([i_sel, j_sel, h_sel, w_sel], 1),
                      fallback[None])
    groups = next(k for k in (8, 4, 2, 1) if n % k == 0)
    return dict(box=box, fb=U(n, 0.6, 1.4), fc=U(n, 0.6, 1.4), fs=U(n, 0.6, 1.4),
                fh=U(n, -0.1, 0.1), jitter=U(n) < 0.8, gray=U(n) < 0.2,
                sigma=U(n, 0.1, 2.0), blur=U(n) < 0.5, flip=U(n) < flip_p,
                perm_ids=torch.randint(0, 24, (groups,), generator=g, device=device))


def resize_weights(in_size: int, out_size: int, start, length) -> torch.Tensor:
    """(N, out, in) weights of the bilinear map of [start, start + length)
    onto ``out_size`` samples (``jax.image.scale_and_translate``)."""
    dev = start.device
    length = length.float()
    scale = torch.full_like(length, float(out_size)) / length
    trans = -start.float() * scale
    inv = 1.0 / scale
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample = (o[None] + 0.5) * inv[:, None] - (trans * inv)[:, None] - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = (1.0 - (sample[:, None, :] - src[None, :, None]).abs()).clamp_min(0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    w = w * ((sample >= -0.5) & (sample <= in_size - 0.5))[:, None, :]
    return w.transpose(1, 2)


def _bc(v):
    return v.reshape(-1, 1, 1, 1, 1)


def _gray(x, keep=True):
    g = (LUMA[0] * x[:, :, 0] + LUMA[1] * x[:, :, 1] + LUMA[2] * x[:, :, 2])[:, :, None]
    return g.expand_as(x) if keep else g


def _brightness(x, f):
    return (x * f).clamp(0.0, 255.0)


def _contrast(x, f):
    mean = _gray(x, False).mean(dim=(-3, -2, -1), keepdim=True)
    return (x * f + mean * (1.0 - f)).clamp(0.0, 255.0)


def _saturation(x, f):
    return (x * f + _gray(x) * (1.0 - f)).clamp(0.0, 255.0)


def _hue(x, shift):
    r, g, b = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    inv = 1.0 / d.clamp_min(1e-6)
    u = torch.where(r == mx, (g - b) * inv,
                    torch.where(g == mx, 2.0 + (b - r) * inv, 4.0 + (r - g) * inv))
    u = u + 6.0 * shift[:, :, 0]
    u = torch.where(u < 0.0, u + 6.0, u)
    u = torch.where(u >= 6.0, u - 6.0, u)
    i = torch.floor(u)
    f = u - i
    p, q, t = mx - d, mx - d * f, mx - d * (1.0 - f)
    i = i.int()

    def sel(*c):
        out = c[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, c[k], out)
        return out

    return torch.stack([sel(mx, q, p, p, t, mx), sel(t, mx, mx, q, p, p),
                        sel(p, p, t, mx, mx, q)], dim=2)


def blur_matrix(size: int, sigma, kernel_size: int = 13):
    r = kernel_size // 2
    ar = torch.arange(size, device=sigma.device)
    d = (ar[:, None] - ar[None, :]).float()
    s2 = (2.0 * sigma.float() ** 2)[:, None, None]
    w = torch.exp(-(d ** 2)[None] / s2)
    w = torch.where(d.abs()[None] <= r, w, torch.zeros_like(w))
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=sigma.device)
    norm = torch.exp(-(xs ** 2)[None] / s2[:, :, 0]).sum(dim=1)
    return w / norm[:, None, None]


def augment(clips: torch.Tensor, seed: int, out_hw, mean, std, flip_p: float = 0.5):
    """(B, V, T, H, W, 3) uint8 -> (B, V, T, oh, ow, 3) float32 from the
    step's augmentation seed."""
    b, v, t, H, W, c = clips.shape
    n, (oh, ow) = b * v, out_hw
    g = torch.Generator(device=clips.device)
    g.manual_seed(int(seed))
    p = draw_params(n, (H, W), g, clips.device, flip_p)
    x = clips.reshape(n, t, H, W, c).permute(0, 1, 4, 2, 3).float()
    top, left, hh, ww = p["box"].unbind(1)
    x = torch.einsum("nyh,ntchw->ntcyw", resize_weights(H, oh, top, hh), x)
    x = torch.einsum("nxw,ntcyw->ntcyx", resize_weights(W, ow, left, ww), x)
    ops = {0: lambda y, f: _brightness(y, f[0]), 1: lambda y, f: _contrast(y, f[1]),
           2: lambda y, f: _saturation(y, f[2]), 3: lambda y, f: _hue(y, f[3])}
    perms = p["perm_ids"].tolist()
    per = n // len(perms)
    parts = []
    for gi, pid in enumerate(perms):
        y = x[gi * per:(gi + 1) * per]
        f = [_bc(p[k][gi * per:(gi + 1) * per]) for k in ("fb", "fc", "fs", "fh")]
        for o in JITTER_PERMS[pid]:
            y = ops[o](y, f)
        parts.append(y)
    x = torch.where(_bc(p["jitter"]), torch.cat(parts), x)
    x = torch.where(_bc(p["gray"]), _gray(x), x)
    bw, bh = blur_matrix(ow, p["sigma"]), blur_matrix(oh, p["sigma"])
    blurred = torch.einsum("ntchk,nhy->ntcyk", torch.einsum("ntchw,nwk->ntchk", x, bw), bh)
    x = torch.where(_bc(p["blur"]), blurred, x)
    x = torch.where(_bc(p["flip"]), x.flip(-1), x)
    m = torch.tensor(mean, device=x.device).reshape(1, 1, c, 1, 1) * 255.0
    s = torch.tensor(std, device=x.device).reshape(1, 1, c, 1, 1) * 255.0
    x = (x - m) / s
    return x.permute(0, 1, 3, 4, 2).reshape(b, v, t, oh, ow, c)
