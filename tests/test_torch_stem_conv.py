"""The stems' convolution (``ops/stem_conv.py``, ``csrc/stem_conv_fwd.cu``).

* The operator's CPU kernel, the plain version, equals ``F.conv3d`` in
  float64 at every stem geometry of the 3D backbones: S3D's 1x7x7 /
  (1,2,2), I3D's 7x7x7 / 2 with its TF-SAME (2, 3) pads, I3D-ResNet-50-NL's
  5x7x7 / 2, SlowFast's Slow 1x7x7 (on its frame table) and Fast 5x7x7 /
  (1,2,2), R3D's 7x7x7 / (1,2,2), the 2-channel Flow stem, tiny3d's
  3x3x3 / 2; F 8, 16 and 64.
* The launch plan: its output extents and pads are ``F.conv3d``'s, its
  blocks fit the card, and a plain emulation of the kernel's arithmetic
  over the plan (staged rows, the A offset table and its masks, the
  weight matrix, the frame ring) equals ``F.conv3d`` on the bf16-rounded
  operands, reading only inside the staged rows.
* The routing predicate picks exactly each registered 3D backbone's
  stem(s) and no convolution with C_in >= 8 (R(2+1)D's 3 -> 110 stem stays
  on the library), and nothing off a CUDA device or outside bf16.
* Through the autograd function the weight (and bias, and input) gradient
  equals ``F.conv3d``'s on the CPU.
* On the card (``cuda`` marker): the kernel against cuDNN at every stem
  shape of the benchmark's three cells and at I3D's, R3D's and the Flow
  stem's, the inputs bit-equal and the outputs within one bf16 ulp of the
  largest output; one MoCo step counts ``stem_conv_fwd`` 2 (S3D,
  I3D-ResNet-50-NL) or 4 (SlowFast) times.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from video_graph_ssl_tpu_torch.ops import stem_conv
from video_graph_ssl_tpu_torch.ops.maxpool import same_padding

# name: (x (B, T, H, W, C), weight (F, C, kt, kh, kw), stride, (lo, hi) pads,
#        Slow frames or None) at small extents with the stems' kernels
GEOMETRIES = {
    "s3d": ((2, 4, 20, 20, 3), (64, 3, 1, 7, 7), (1, 2, 2), ((0, 0), (3, 3), (3, 3)), None),
    "i3d_same": ((2, 6, 18, 18, 3), (64, 3, 7, 7, 7), (2, 2, 2), ((2, 3), (2, 3), (2, 3)),
                 None),
    "i3dnl": ((2, 6, 18, 18, 3), (64, 3, 5, 7, 7), (2, 2, 2), ((2, 2), (3, 3), (3, 3)), None),
    "slow": ((2, 8, 20, 20, 3), (64, 3, 1, 7, 7), (1, 2, 2), ((0, 0), (3, 3), (3, 3)),
             (0, 2, 5, 7)),
    "fast": ((2, 8, 20, 20, 3), (8, 3, 5, 7, 7), (1, 2, 2), ((2, 2), (3, 3), (3, 3)), None),
    "r3d": ((2, 5, 18, 18, 3), (64, 3, 7, 7, 7), (1, 2, 2), ((3, 3), (3, 3), (3, 3)), None),
    "flow": ((2, 4, 20, 20, 2), (64, 2, 1, 7, 7), (1, 2, 2), ((0, 0), (3, 3), (3, 3)), None),
    "tiny": ((2, 4, 16, 16, 3), (16, 3, 3, 3, 3), (2, 2, 2), ((1, 1), (1, 1), (1, 1)), None),
    "odd_w": ((1, 3, 17, 35, 3), (8, 3, 3, 5, 5), (1, 1, 1), ((1, 1), (2, 1), (0, 2)), None),
}
IDS = list(GEOMETRIES)
# the kernel's instantiations as the H100 build reports them for a bf16 x
# (``stem_conv.kernel_variants``): index, NT, MT, warps, blocks an SM,
# registers a thread
VARIANTS = tuple(stem_conv.Variant(*v) for v in (
    (0, 1, 4, 16, 1, 106), (1, 2, 8, 16, 1, 128), (2, 4, 4, 8, 1, 153),
    (3, 8, 2, 8, 2, 128), (4, 8, 2, 12, 1, 167)))


def _inputs(name, dtype, seed=0):
    xs, ws, stride, pads, frames = GEOMETRIES[name]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(xs, generator=g, dtype=torch.float64).to(dtype)
    w = (torch.randn(ws, generator=g, dtype=torch.float64) / np.sqrt(np.prod(ws[1:]))).to(dtype)
    fr = None if frames is None else torch.tensor(frames, dtype=torch.int64)
    flat = [v for pair in pads for v in pair]
    return x, w, stride, pads, flat, fr


def _reference(x, w, bias, stride, pads, frames):
    """``F.conv3d`` on the explicitly zero-padded (B, C, T, H, W) clip."""
    if frames is not None:
        x = x[:, frames]
    xn = x.permute(0, 4, 1, 2, 3)
    (lt, ht), (lh, hh), (lw, hw) = pads
    return F.conv3d(F.pad(xn, (lw, hw, lh, hh, lt, ht)), w, bias, stride)


@pytest.mark.parametrize("name", IDS)
def test_plain_equals_conv3d_float64(name):
    x, w, stride, pads, flat, fr = _inputs(name, torch.float64)
    bias = torch.randn(w.shape[0], dtype=torch.float64)
    for b in (None, bias):
        got = stem_conv.stem_conv3d_fwd_op(x, w, b, list(stride), flat, fr)
        want = _reference(x, w, b, stride, pads, fr)
        assert got.shape == want.shape
        assert got.is_contiguous(memory_format=torch.channels_last_3d)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", IDS)
def test_plan_extents_and_blocks(name):
    x, w, stride, pads, flat, fr = _inputs(name, torch.float32)
    tsel = x.shape[1] if fr is None else len(fr)
    p = stem_conv.plan(tuple(x.shape), tsel, tuple(w.shape), stride, pads, VARIANTS)
    want = _reference(x.double(), w.double(), None, stride, pads, fr).shape
    assert (x.shape[0], w.shape[0], *p.out) == tuple(want)
    kt, kh, kw = w.shape[2:]
    c = x.shape[4]
    # the plan's pads are the (lo, hi) pads: F.conv3d's output for them
    assert p.group % 2 == 0 and p.group >= kw * c + p.lead
    assert p.kspd * 16 >= kh * p.group
    assert p.smem <= stem_conv.MAX_SMEM_BYTES
    v = VARIANTS[p.variant]
    assert v.nt == p.nt
    assert p.warps == -(-p.rh * p.wt // v.mt) <= v.max_warps
    assert p.rp % 4 == 0 and p.xoff % 4 == 0 and p.xoff == p.zoff + pads[2][0] * c
    assert p.units == x.shape[0] * -(-p.out[1] // p.rh)
    assert p.sr == (p.rh - 1) * stride[1] + kh


def _emulate(x, w, stride, pads, frames, p):
    """The kernel's arithmetic over its plan, in float64 on bf16-rounded
    operands: weights as the block stages them (K ordered dt, dh, then the
    (dw, c) run of a staged row with its lead or trailing pad), the staged
    frames of each unit in a ring of kt, the A offsets and masks of the
    per-lane table, one output frame at a time."""
    b_, t_, h_, w_, c = x.shape
    f, _, kt, kh, kw = w.shape
    st, sh, sw = stride
    (pt, _), (ph, _), _ = pads
    to_, ho, wo = p.out
    kwc = kw * c
    kdt = p.kspd * 16
    tsel = t_ if frames is None else len(frames)
    xb = x.to(torch.bfloat16).double().reshape(b_, t_, h_, w_ * c)
    wb = w.to(torch.bfloat16).double()
    # weights and the per-k offsets / validity inside one frame
    wm = torch.zeros(f, kt * kdt, dtype=torch.float64)
    off = np.zeros(kdt, np.int64)
    valid = np.zeros(kdt, bool)
    for kk in range(kdt):
        dh, j = divmod(kk, p.group)
        e = j - p.lead
        off[kk] = dh * p.rp + e if dh < kh else -p.lead
        valid[kk] = dh < kh and 0 <= e < kwc
    for k in range(kt * kdt):
        dt, kk = divmod(k, kdt)
        dh, j = divmod(kk, p.group)
        e = j - p.lead
        if dh < kh and 0 <= e < kwc:
            dw, ci = divmod(e, c)
            wm[:, k] = wb[:, ci, dt, dh, dw]
    y = torch.zeros(b_, f, to_, ho, wo, dtype=torch.float64)
    rows = np.arange(p.rh * p.wt) // p.wt
    cols = np.arange(p.rh * p.wt) % p.wt
    pos_r = np.repeat(rows, 16)
    pos_w = (np.repeat(cols, 16) * 16 + np.tile(np.arange(16), p.rh * p.wt))
    base = pos_r * sh * p.rp + pos_w * sw * c + p.zoff          # (positions,)
    idx = base[:, None] + off[None, :]                          # (positions, kdt)
    assert idx.min() >= 0
    if (sw * c) % 2 == 0:
        # every pair (k even, k + 1), masked or not, is one aligned 4-byte load
        taps = (np.arange(0, kdt, 2) // p.group) < kh
        assert np.all(idx[:, 0::2] % 2 == 0)
        assert np.all((idx[:, 1::2] == idx[:, 0::2] + 1)[:, taps])
        assert (p.sr * p.rp) % 2 == 0
    # every valid read lies in the row of its tap, inside the staged row
    row_of = (pos_r * sh)[:, None] + (np.arange(kdt) // p.group)[None, :]
    assert np.all((idx // p.rp == row_of)[:, valid])
    assert idx.max() < p.sr * p.rp
    for unit in range(p.units):
        b, hb = divmod(unit, p.hb)
        h0 = hb * p.rh
        ring = torch.zeros(kt, p.sr * p.rp, dtype=torch.float64)
        for t in range(to_):
            first = t * st - pt
            lo = first if t == 0 else max(first, first - st + kt)
            for fi in range(lo, first + kt):
                slot = ring[fi % kt].view(p.sr, p.rp)
                slot.zero_()
                if not 0 <= fi < tsel:
                    continue
                tx = fi if frames is None else int(frames[fi])
                for r in range(p.sr):
                    hin = h0 * sh - ph + r
                    if 0 <= hin < h_:
                        e0 = p.xoff
                        n = min(w_ * c, p.rp - e0)
                        slot[r, e0:e0 + n] = xb[b, tx, hin, :n]
            a = torch.zeros(len(base), kt * kdt, dtype=torch.float64)
            for dt in range(kt):
                frame = ring[(first + dt) % kt]
                a[:, dt * kdt:(dt + 1) * kdt] = torch.where(
                    torch.from_numpy(valid)[None, :], frame[torch.from_numpy(idx)], 0.0)
            out = a @ wm.T                                       # (positions, F)
            for m, (r, wpos) in enumerate(zip(pos_r, pos_w)):
                if h0 + r < ho and wpos < wo:
                    y[b, :, t, h0 + r, wpos] = out[m]
    return y


@pytest.mark.parametrize("name", IDS)
def test_kernel_emulation_equals_conv3d(name):
    x, w, stride, pads, flat, fr = _inputs(name, torch.float32, seed=3)
    tsel = x.shape[1] if fr is None else len(fr)
    p = stem_conv.plan(tuple(x.shape), tsel, tuple(w.shape), stride, pads, VARIANTS)
    got = _emulate(x, w, stride, pads, fr, p)
    want = _reference(x.to(torch.bfloat16).double(), w.to(torch.bfloat16).double(), None,
                      stride, pads, fr)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("rh", [1, 2, 3])
def test_kernel_emulation_every_strip(rh):
    """Strips that do not divide the output rows, and a ring that wraps."""
    x, w, stride, pads, flat, fr = _inputs("fast", torch.float32, seed=4)
    p = stem_conv.plan(tuple(x.shape), x.shape[1], tuple(w.shape), stride, pads, VARIANTS, rh=rh)
    got = _emulate(x, w, stride, pads, fr, p)
    want = _reference(x.to(torch.bfloat16).double(), w.to(torch.bfloat16).double(), None,
                      stride, pads, fr)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def _stems(name):
    """The convolutions of registered 3D backbone ``name`` that the
    predicate routes to the kernel on a CUDA device in bf16 (the model
    built on the meta device)."""
    from video_graph_ssl_tpu_torch.models.build import BACKBONES_3D
    ctor = BACKBONES_3D[name][0]
    with torch.device("meta"):
        model = ctor(dtype=torch.bfloat16)
    cuda = torch.device("cuda")
    return {n for n, m in model.named_modules() if isinstance(m, torch.nn.Conv3d)
            and stem_conv.routes(cuda, torch.bfloat16, m.weight, m.groups, m.dilation)}


STEM_NAMES = {"S3D": {"base.0.conv_s"}, "S3DG": {"base.0.conv_s"}, "I3D": {"base.0.conv"},
              "InceptionI3d": {"base.0.conv"}, "i3d_res50_nonlocal": {"conv1"},
              "slowfast_r50": {"slow_conv1", "fast_conv1"}, "tiny3d": {"stage0.conv"}}


def _registered():
    from video_graph_ssl_tpu_torch.models.build import BACKBONES_3D
    return sorted(BACKBONES_3D)


@pytest.mark.parametrize("name", _registered())
def test_routing_picks_the_stems_alone(name):
    got = _stems(name)
    if name in STEM_NAMES:
        want = STEM_NAMES[name]
    elif name.startswith("resnet2p1d"):
        want = set()          # its 3 -> 110 stem: F not a multiple of 8
    else:
        want = {"conv1"}      # the 3D ResNets' 7x7x7 stem
    assert got == want


def test_routing_needs_cuda_bf16_and_few_channels():
    w = torch.empty(64, 3, 1, 7, 7, device="meta")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert stem_conv.routes(cuda, torch.bfloat16, w)
    assert not stem_conv.routes(cpu, torch.bfloat16, w)
    assert not stem_conv.routes(cuda, torch.float32, w)
    assert not stem_conv.routes(cuda, torch.bfloat16, w, groups=3)
    assert not stem_conv.routes(cuda, torch.bfloat16, w, dilation=(1, 2, 2))
    assert not stem_conv.routes(cuda, torch.bfloat16, torch.empty(64, 8, 1, 1, 1, device="meta"))
    assert not stem_conv.routes(cuda, torch.bfloat16, torch.empty(110, 3, 1, 7, 7, device="meta"))
    assert not stem_conv.routes(cuda, torch.bfloat16, torch.empty(64, 12, 1, 4, 4, device="meta"))
    assert not stem_conv.routes(cuda, torch.bfloat16, torch.empty(64, 3, 7, 7, device="meta"))
    assert stem_conv.routes(cuda, torch.bfloat16, torch.empty(8, 2, 5, 7, 7, device="meta"))


@pytest.mark.parametrize("name", ["s3d", "i3d_same", "slow", "fast"])
def test_autograd_gradients_equal_conv3d(name):
    x, w, stride, pads, flat, fr = _inputs(name, torch.float64, seed=5)
    bias = torch.randn(w.shape[0], dtype=torch.float64)
    wa, ba, xa = (t.clone().requires_grad_(True) for t in (w, bias, x))
    wb, bb, xb = (t.clone().requires_grad_(True) for t in (w, bias, x))
    y = stem_conv.stem_conv3d(xa.permute(0, 4, 1, 2, 3), wa, ba, stride, pads,
                              torch.float64, fr)
    ref = _reference(xb, wb, bb, stride, pads, fr)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-12)
    gy = torch.randn(ref.shape, dtype=torch.float64)
    (y * gy).sum().backward()
    (ref * gy).sum().backward()
    for got, want in ((wa.grad, wb.grad), (ba.grad, bb.grad), (xa.grad, xb.grad)):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_plain_and_gradients_on_a_planar_view():
    """x as the augmentation hands it over: one of two views, each frame's
    channel planes apart with H fastest; the backward keeps x itself."""
    x, w, stride, pads, flat, fr = _inputs("i3dnl", torch.float64, seed=8)
    two = torch.stack([x, x.flip(0)], 1).permute(0, 1, 2, 5, 4, 3).contiguous()
    view = two.permute(0, 1, 2, 5, 4, 3)[:, 0]
    assert not view.is_contiguous() and torch.equal(view, x)
    got = stem_conv.stem_conv3d_fwd_op(view, w, None, list(stride), flat, None)
    torch.testing.assert_close(got, _reference(x, w, None, stride, pads, None), rtol=0,
                               atol=1e-12)
    wa = w.clone().requires_grad_(True)
    y = stem_conv.stem_conv3d(view.permute(0, 4, 1, 2, 3), wa, None, stride, pads,
                              torch.float64)
    assert y.grad_fn.saved_tensors[0].data_ptr() == view.data_ptr()
    y.sum().backward()
    wb = w.clone().requires_grad_(True)
    _reference(x, wb, None, stride, pads, None).sum().backward()
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-10, atol=1e-10)


def test_no_grad_pass_keeps_nothing_and_weight_only_grad():
    x, w, stride, pads, flat, fr = _inputs("s3d", torch.float64, seed=6)
    wp = w.clone().requires_grad_(True)
    with torch.no_grad():
        y = stem_conv.stem_conv3d(x.permute(0, 4, 1, 2, 3), wp, None, stride, pads,
                                  torch.float64)
    assert y.grad_fn is None
    y = stem_conv.stem_conv3d(x.permute(0, 4, 1, 2, 3), wp, None, stride, pads, torch.float64)
    assert y.grad_fn is not None
    y.sum().backward()
    ref_w = w.clone().requires_grad_(True)
    _reference(x, ref_w, None, stride, pads, None).sum().backward()
    torch.testing.assert_close(wp.grad, ref_w.grad, rtol=1e-10, atol=1e-10)


def test_conv3d_same_pads_match_jax_rule():
    """I3D's stem pads (2, 3) at even extents through conv3d_same, whose
    library path equals F.conv3d on the padded clip."""
    from video_graph_ssl_tpu_torch.models.layers import conv3d_same
    x, w, stride, pads, flat, fr = _inputs("i3d_same", torch.float64, seed=7)
    assert same_padding(x.shape[1:4], w.shape[2:], stride) == pads
    got = conv3d_same(x.permute(0, 4, 1, 2, 3), w, None, stride, torch.float64)
    torch.testing.assert_close(got, _reference(x, w, None, stride, pads, None), rtol=0,
                               atol=1e-12)


def test_profile_classes_the_kernel():
    """``profile_step.py`` files the kernel as "stem conv forward"; the
    benchmark's frozen classes file it with the convolutions, so no
    roofline of a hand-written kernel reads it."""
    import re
    from pathlib import Path

    from portbench.core.trace import classify
    from portbench.metrics._classes import CLASSES
    from video_graph_ssl_tpu_torch import profile_step

    text = (Path(stem_conv.__file__).resolve().parent.parent / "csrc"
            / "stem_conv_fwd.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                       text)
    assert names == ["stem_conv_fwd_kernel"]
    traced = ("void (anonymous namespace)::stem_conv_fwd_kernel<__nv_bfloat16, 8, 2, 256, 2>("
              "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, long long "
              "const*, __nv_bfloat16*, (anonymous namespace)::StemGeom)")
    for name in (traced, names[0]):
        assert profile_step.classify(name) == "stem conv forward"
        assert classify(name, CLASSES) == "conv (cuDNN/cutlass)"


# --- on the card -------------------------------------------------------------

# every stem of the benchmark's cells at bs 256 / 64 and I3D's, R3D's and the
# Flow stem's at bs 128, 16x112x112: (x, weight, stride, pads, Slow frames)
CARD_SHAPES = {
    "s3d_b256": ((256, 16, 112, 112, 3), (64, 3, 1, 7, 7), (1, 2, 2),
                 ((0, 0), (3, 3), (3, 3)), None),
    "i3dnl_b256": ((256, 16, 112, 112, 3), (64, 3, 5, 7, 7), (2, 2, 2),
                   ((2, 2), (3, 3), (3, 3)), None),
    "slowfast_slow_b64": ((64, 32, 224, 224, 3), (64, 3, 1, 7, 7), (1, 2, 2),
                          ((0, 0), (3, 3), (3, 3)), (0, 4, 8, 13, 17, 22, 26, 31)),
    "slowfast_fast_b64": ((64, 32, 224, 224, 3), (8, 3, 5, 7, 7), (1, 2, 2),
                          ((2, 2), (3, 3), (3, 3)), None),
    "i3d_b128": ((128, 16, 112, 112, 3), (64, 3, 7, 7, 7), (2, 2, 2),
                 ((2, 3), (2, 3), (2, 3)), None),
    "r3d_b128": ((128, 16, 112, 112, 3), (64, 3, 7, 7, 7), (1, 2, 2),
                 ((3, 3), (3, 3), (3, 3)), None),
    "flow_b128": ((128, 16, 112, 112, 2), (64, 2, 1, 7, 7), (1, 2, 2),
                  ((0, 0), (3, 3), (3, 3)), None),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_check(name: str, x_dtype=torch.float32, seed: int = 0, planar: bool = False) -> dict:
    """The kernel against cuDNN (``F.conv3d`` on the bf16 NCDHW clip, as the
    library path runs it) at card shape ``name``: the largest difference
    and one bf16 ulp of the largest output.  ``planar``: x is the second of
    two views with each frame's channel planes apart, H fastest, as the
    augmentation hands the clips to the encoders."""
    xs, ws, stride, pads, frames = CARD_SHAPES[name]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    if planar:
        b, t, h, w_, c = xs
        x = torch.randn((b, 2, t, c, w_, h), generator=g, device=dev).to(x_dtype)
        x = x.permute(0, 1, 2, 5, 4, 3)[:, 1]
    else:
        x = torch.randn(xs, generator=g, device=dev).to(x_dtype)
    w = torch.randn(ws, generator=g, device=dev) / float(np.sqrt(np.prod(ws[1:])))
    fr = None if frames is None else torch.tensor(frames, dtype=torch.int64, device=dev)
    xn = x.permute(0, 4, 1, 2, 3)
    x_bits = x.clone()
    y = stem_conv.stem_conv3d(xn, w, None, stride, pads, torch.bfloat16, fr)
    sel = xn if fr is None else xn.index_select(2, fr)
    want = _reference(sel.permute(0, 2, 3, 4, 1).to(torch.bfloat16), w.to(torch.bfloat16),
                      None, stride, pads, None)
    torch.cuda.synchronize()
    big = want.float().abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
    return {"inputs_equal": bool(torch.equal(x, x_bits)),
            "shape_equal": tuple(y.shape) == tuple(want.shape),
            "channels_last": y.is_contiguous(memory_format=torch.channels_last_3d),
            "max_abs_err": (y.float() - want.float()).abs().max().item(), "ulp": ulp}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_kernel_equals_cudnn_on_card(name):
    _cuda()
    r = card_check(name)
    assert r["inputs_equal"] and r["shape_equal"] and r["channels_last"]
    assert r["max_abs_err"] <= r["ulp"], r


@pytest.mark.cuda
@pytest.mark.parametrize("name,planar", [("s3d_b256", False), ("i3dnl_b256", True),
                                         ("slowfast_slow_b64", True),
                                         ("slowfast_fast_b64", True), ("flow_b128", True)])
def test_kernel_reads_bf16_clips_on_card(name, planar):
    """bf16 clips, contiguous or as the augmentation's views."""
    _cuda()
    r = card_check(name, x_dtype=torch.bfloat16, seed=1, planar=planar)
    assert r["inputs_equal"] and r["max_abs_err"] <= r["ulp"], r


@pytest.mark.cuda
def test_kernel_variants_as_built_on_card():
    """The instantiations the built library reports, in index order: each
    NT has one or more, each within its launch bound's registers."""
    _cuda()
    for x_bf16 in (False, True):
        vs = stem_conv.kernel_variants(x_bf16)
        assert [v.index for v in vs] == list(range(len(vs)))
        assert {v.nt for v in vs} == {1, 2, 4, 8}
        for v in vs:
            assert 0 < v.regs <= min(255, 65536 // (v.max_warps * 32 * v.minb)), v


@pytest.mark.cuda
@pytest.mark.parametrize("backbone,calls", [("S3D", 2), ("i3d_res50_nonlocal", 2),
                                            ("slowfast_r50", 4)])
def test_moco_step_counts_stem_calls_on_card(backbone, calls, tmp_path):
    """One GCA MoCo step (key and query pass) at a small batch launches the
    kernel once per stem and pass."""
    dev = _cuda()
    from video_graph_ssl_tpu_torch.train_video_contrast_dis import Trainer, load_config
    from video_graph_ssl_tpu_torch.utils import tracing
    cfg = load_config("configs/visual_moco.yaml", [
        "MODEL.BACKBONE", backbone, "MODEL.AUG_FLAG", "True", "DATASET.SOURCE", "synthetic",
        "DATALOADER.BATCH_SIZE", "4", "CONTRAST.NCE_K", "64", "DATASET.NUM_CLASS", "8",
        "INPUT.VIDEO_LENGTH", "32" if backbone == "slowfast_r50" else "16"])
    trainer = Trainer(cfg, max_steps=2, device=str(dev), run_dir=str(tmp_path))
    epoch = trainer.train_loader.epoch(0)
    clips = [trainer.to_device(b) for b in itertools.islice(epoch, 2)]
    epoch.close()
    lr = trainer.lr_fn(0)
    trainer.train_step(clips[0], lr)
    torch.cuda.synchronize()
    tracing.reset_counters()
    trainer.train_step(clips[1], lr)
    torch.cuda.synchronize()
    assert tracing.counters()["stem_conv_fwd"] == calls
