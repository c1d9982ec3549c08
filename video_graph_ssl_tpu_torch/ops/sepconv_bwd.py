"""Kernel wrapper of the SepConv pair's three-sweep backward (K5).

Counterpart of ``video_graph_ssl_tpu/ops/pallas/sepconv_bwd.py`` (K5) and
``ops/pallas/sepconv_bwd_grid.py`` (K6): one CUDA family,
``csrc/sepconv_bwd.cu``, covers every shape of the pair (k = 3, stride 1,
pad 1).  :func:`sepconv_bwd` takes CUDA tensors only; its plain version is
``ops/fused_sepconv.py:bwd_reference``, which ``FusedSepConvTrain`` runs
for CPU tensors.  Arguments and outputs are those of ``bwd_reference``.
"""

from __future__ import annotations

import torch

from . import _build, fused_sepconv

# Wrapper calls since the last reset (one call = the three sweeps, 12
# kernel launches).
launches = 0
# cotangents that reached the kernel in another memory format and were
# copied to channels_last_3d first.
g_copies = 0

_CL = torch.channels_last_3d
# Target number of blocks of a weight-gradient product: enough to fill the
# card's 132 SMs several times over.  Each row split keeps one fp32 partial
# of the weight gradient, so the count also bounds that scratch.
_WGRAD_BLOCKS = 1024
_MAX_SPLITS = 64


def wgrad_splits(rows: int, taps: int, k: int, n: int) -> int:
    """Row splits of a weight-gradient product: about ``_WGRAD_BLOCKS``
    blocks in all, at least 256 rows each."""
    tiles = taps * -(-k // 64) * -(-n // 64)
    want = -(-_WGRAD_BLOCKS // tiles)
    return max(1, min(want, _MAX_SPLITS, -(-rows // 256)))


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


def sepconv_bwd(x, ws, wt, g1, b1, g2, b2, mu1, var1, mu2, var2, g, dtype):
    """One kernel call: (dx, dWs, dWt, dgamma1, dbeta1, dgamma2, dbeta2)."""
    global launches, g_copies
    _check(x, ws, wt, g, dtype)
    b, c, t, h, w = x.shape
    f = ws.shape[0]
    dev = x.device
    xc = x.to(dtype).contiguous(memory_format=_CL)
    gc = g.to(dtype)
    if not gc.is_contiguous(memory_format=_CL):
        gc = gc.contiguous(memory_format=_CL)
        g_copies += 1
    wsc = ws.to(dtype)[:, :, 0]            # (F, C, 3, 3)
    wtc = wt.to(dtype)[:, :, :, 0, 0]      # (F, F', 3)
    w1 = wsc.permute(2, 3, 1, 0).reshape(9, c, f).contiguous()   # [kh*3+kw][c][f]
    w2 = wtc.permute(2, 1, 0).contiguous()                       # [k][f'][f]
    w3 = wtc.permute(2, 0, 1).contiguous()                       # [k][f][f']
    w4 = wsc.permute(2, 3, 0, 1).reshape(9, f, c).contiguous()   # [kh*3+kw][f][c]
    f32 = dict(dtype=torch.float32, device=dev)
    eps = fused_sepconv.EPS
    bn1 = torch.stack([mu1, torch.rsqrt(var1 + eps), g1, b1]).to(**f32).contiguous()
    bn2 = torch.stack([mu2, torch.rsqrt(var2 + eps), g2, b2]).to(**f32).contiguous()

    rows = b * t * h * w
    act = dict(dtype=dtype, device=dev, memory_format=_CL)
    y1, a, y2, dz1 = (torch.empty((b, f, t, h, w), **act) for _ in range(4))
    dx = torch.empty((b, c, t, h, w), **act)
    bn_part = torch.empty((-(-rows // 64), 2, f), **f32)
    splits_s = wgrad_splits(rows, 9, c, f)
    splits_t = wgrad_splits(rows, 3, f, f)
    wpart = torch.empty(max(splits_s * 9 * c * f, splits_t * 3 * f * f), **f32)
    s1, m1, s2, m2 = (torch.empty((2, f), **f32) for _ in range(4))
    dws = torch.empty((9, c, f), **f32)
    dwt = torch.empty((3, f, f), **f32)

    lib = _build.library()
    code = lib.vgs_sepconv_bwd(
        xc.data_ptr(), gc.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
        w4.data_ptr(), bn1.data_ptr(), bn2.data_ptr(), y1.data_ptr(), a.data_ptr(),
        y2.data_ptr(), dz1.data_ptr(), bn_part.data_ptr(), wpart.data_ptr(),
        s1.data_ptr(), m1.data_ptr(), s2.data_ptr(), m2.data_ptr(), dx.data_ptr(),
        dws.data_ptr(), dwt.data_ptr(), b, t, h, w, c, f, splits_s, splits_t,
        int(dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "vgs_sepconv_bwd")
    launches += 1
    dws = dws.reshape(3, 3, c, f).permute(3, 2, 0, 1).unsqueeze(2)   # (F, C, 1, 3, 3)
    dwt = dwt.permute(2, 1, 0)[..., None, None]                      # (F, F', 3, 1, 1)
    return (dx.to(x.dtype), dws.to(ws.dtype).contiguous(), dwt.to(wt.dtype).contiguous(),
            s1[1].to(g1.dtype), s1[0].to(b1.dtype), s2[1].to(g2.dtype), s2[0].to(b2.dtype))
