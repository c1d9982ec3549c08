"""Launch plans of the port's graph kernels, K1 (graph adjacency,
``ops/graph_kernel.py:adjacency_plan``) and K2 (GCN propagation,
``ops/gcn_propagate.py:propagate_plan``), on the CPU; and both kernels
against their plain versions on the card.

* K1: D is split across blocks so that the grid fills the SMs several
  times; the splits partition D's vectors (no empty split), 16-byte loads
  where D allows, a thread's pair tile covers T, the scratch holds one
  partial T x T per block.  The plain-PyTorch emulation of the split sums
  (each split's q.k^T, added in split order) equals the similarity.
* K2: the tensor-core route for bf16 with F a multiple of 8, T padded to
  16 or 32; the CUDA-core route otherwise; the warps' runs of consecutive
  items cover every (clip, 64-column slice) once.
* ``profile_step.py`` classes every kernel of K1 as "K1 adjacency" and of
  K2 as "K2 propagate", so the step profile shows each on its own.
* On the card (``cuda`` marker, ``python -m pytest -m cuda
  tests/test_torch_graph_plan.py``): both kernels against their plain
  versions at T = 32, at ragged D and F and at the step's first shape (at a
  small batch), forward and transpose, each twice, bit-equal.

No JAX here: the file runs on the card as it is.
"""

import math
import re
from pathlib import Path

import pytest
import torch

from video_graph_ssl_tpu_torch import profile_step
from video_graph_ssl_tpu_torch.ops import gcn_propagate as gp
from video_graph_ssl_tpu_torch.ops import graph_kernel as gk
from video_graph_ssl_tpu_torch.ops.temporal_graph import hop_weight_matrix
from video_graph_ssl_tpu_torch.utils import tracing

torch.set_num_threads(1)
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}

# (B, T, D) of K1 and (B, T, F) of K2 at the bs-128 step's aug points
K1_STEP = [(128, 8, 7 * 7 * 96), (128, 4, 3 * 3 * 256), (128, 2, 1 * 1 * 416)]
K2_STEP = [(128, 8, 14 * 14 * 192), (128, 4, 7 * 7 * 512), (128, 2, 3 * 3 * 832)]
# T = 32, ragged D (not a multiple of a 16-byte vector), D below one split
K1_EDGE = [(4, 32, 4704), (6, 32, 200), (5, 8, 37), (3, 5, 1001), (128, 8, 3)]
K2_EDGE = [(4, 32, 1024), (3, 32, 360), (2, 3, 105), (5, 8, 360), (2, 17, 7)]


@pytest.mark.parametrize("dn", list(DTYPES))
@pytest.mark.parametrize("shape", K1_STEP + K1_EDGE, ids=str)
def test_adjacency_plan(shape, dn):
    b, t, d = shape
    dt = DTYPES[dn]
    plan = gk.adjacency_plan(b, t, d, dt)
    esize = dt.itemsize
    assert plan.vec == (16 // esize if (d * esize) % 16 == 0 else 1)
    assert plan.vectors * plan.vec == d
    # the splits partition D's vectors, none empty
    assert (plan.splits - 1) * plan.per_split < plan.vectors <= plan.splits * plan.per_split
    assert plan.blocks == b * plan.splits and plan.scratch == b * plan.splits * t * t
    assert plan.epilogue_blocks * 8 >= b * t            # a warp per row
    # the tiles cover T x T; the lanes share a block's threads evenly
    assert plan.tile in (2, 4, 8) and plan.tile >= min(t, 8)
    assert plan.tiles == math.ceil(t / plan.tile) ** 2 and plan.tiles * plan.lanes == gk.THREADS
    # as many splits as reach the target, unless a split would hold fewer
    # vectors than half its lanes
    if plan.splits > 1:
        assert plan.per_split * 2 > plan.lanes
        assert b * (plan.splits - 1) < gk.TARGET_BLOCKS
    if d < plan.lanes:
        assert plan.splits == 1
    assert gk.adjacency_plan(b, t, d, dt, aligned=False).vec == 1


def test_adjacency_plan_at_the_step_shapes():
    """The first aug point's (128, 8, 4704) bf16: 5 splits of 118 16-byte
    vectors, 640 blocks (4.8 per SM); the smallest stays one split."""
    p = [gk.adjacency_plan(*s, torch.bfloat16) for s in K1_STEP]
    assert [(q.vec, q.tile, q.splits, q.per_split, q.blocks) for q in p] == [
        (8, 8, 5, 118, 640), (8, 4, 3, 96, 384), (8, 2, 1, 52, 128)]


@pytest.mark.parametrize("shape", [(2, 8, 4704), (3, 32, 200), (2, 5, 37)], ids=str)
def test_adjacency_split_sums_equal_the_similarity(shape):
    """q.k^T as the kernel forms it: a partial per split of D's vectors,
    summed in split order (float64 here, so the order is exact enough)."""
    b, t, d = shape
    plan = gk.adjacency_plan(b, t, d, torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn(b, t, d, generator=g, dtype=torch.float64) for _ in range(2))
    sim = torch.zeros(b, t, t, dtype=torch.float64)
    for sp in range(plan.splits):
        lo = sp * plan.per_split * plan.vec
        hi = min(d, lo + plan.per_split * plan.vec)
        sim += q[:, :, lo:hi] @ k[:, :, lo:hi].transpose(1, 2)
    torch.testing.assert_close(sim, q @ k.transpose(1, 2), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dn", list(DTYPES))
@pytest.mark.parametrize("shape", K2_STEP + K2_EDGE, ids=str)
def test_propagate_plan(shape, dn):
    b, t, f = shape
    dt = DTYPES[dn]
    plan = gp.propagate_plan(b, t, f, dt)
    if dt == torch.bfloat16 and f % 8 == 0:
        assert plan.route == "tc" and plan.kpad == (16 if t <= 16 else 32)
        assert plan.items == b * math.ceil(f / gp.TC_COLS)
        # the warps' runs of per_warp items cover the items, no block idle
        run = gp.TC_WARPS * plan.per_warp
        assert plan.per_warp == gp.TC_RUN == gp.TC_STAGES
        assert (plan.blocks - 1) * run < plan.items <= plan.blocks * run
        # per warp: one zero row (ldmatrix's rows past T) and the ring
        assert plan.smem_bytes == gp.TC_WARPS * (1 + gp.TC_STAGES * t) * gp.TC_ROW * 2
        assert plan.smem_bytes <= 232448 and plan.threads == 32 * gp.TC_WARPS
    else:
        assert plan.route == "simt"
        assert plan.vec == (4 if dt == torch.float32 and f % 4 == 0 else 1)
        assert plan.items * plan.vec == b * f
        assert plan.blocks * plan.threads >= plan.items > (plan.blocks - 1) * plan.threads
    assert gp.propagate_plan(b, t, f, dt, aligned=False).route == "simt"


def test_propagate_plan_at_the_step_shapes():
    """Every step shape takes the tensor-core route with T padded to 16, a
    warp per run of 4 consecutive 64-column slices."""
    p = [gp.propagate_plan(*s, torch.bfloat16) for s in K2_STEP]
    assert [(q.route, q.kpad, q.items, q.per_warp, q.blocks, q.smem_bytes) for q in p] == [
        ("tc", 16, 75264, 4, 4704, 19008), ("tc", 16, 50176, 4, 3136, 9792),
        ("tc", 16, 14976, 4, 936, 5184)]


@pytest.mark.parametrize("src,label", [("graph_adjacency.cu", "K1 adjacency"),
                                       ("gcn_propagate.cu", "K2 propagate")])
def test_profile_classes_every_graph_kernel(src, label):
    text = (Path(gk.__file__).resolve().parent.parent / "csrc" / src).read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                       text)
    assert len(names) == 2, names
    for n in names:
        traced = f"void (anonymous namespace)::{n}<__nv_bfloat16, 8, 8, 0>(int)"
        assert profile_step.classify(traced) == label, n
        assert profile_step.classify(n) == label, n
    assert profile_step.classify("ampere_bf16_s16816gemm_bf16_128x64") == "gemm"


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / max(1.0, float(b.float().abs().max())))


# (B, T, D): T = 32 with 16-byte loads and many splits, T = 32 with few,
# ragged D (scalar loads), T between the tiles, D below one split, and the
# step's first shape at batch 8
K1_CARD = [(4, 32, 4704), (6, 32, 200), (5, 8, 37), (3, 5, 1001), (16, 8, 3), (8, 8, 4704)]


@pytest.mark.cuda
@pytest.mark.parametrize("dn", list(DTYPES))
@pytest.mark.parametrize("shape", K1_CARD, ids=str)
def test_adjacency_kernel_equals_plain_on_card(shape, dn):
    dev = _cuda()
    b, t, d = shape
    dt = DTYPES[dn]
    g = torch.Generator(device=dev).manual_seed(0)
    q = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(dt)
    k = (torch.randn(b, t, d, device=dev, generator=g) / d ** 0.25).to(dt)
    u = torch.rand(b, t, t, device=dev, generator=g) * (1 - 2e-6) + 1e-6
    theta = torch.from_numpy(hop_weight_matrix(t, 3, 0.5)).to(dev)
    for nei in (0, 3):
        got = gk.adjacency_fwd_kernel(q, k, theta, None, 0, 1.0, False, nei)
        want = gk._adjacency_fwd_plain(q, k, theta, None, 0, 1.0, False, nei)
        for x, y in zip(got, want):
            assert _rel(x, y) <= 1e-5
    # sampled: given noise against the plain version; the in-kernel draw
    # twice with one seed, bit-equal, and a partial-sum order that holds
    a = gk.adjacency_fwd_kernel(q, k, theta, u, 0, 1.0, True, 0)[0]
    assert _rel(a, gk._adjacency_fwd_plain(q, k, theta, u, 0, 1.0, True, 0)[0]) <= 1e-4
    first = gk.adjacency_fwd_kernel(q, k, theta, None, 11, 0.5, True, 0)
    second = gk.adjacency_fwd_kernel(q, k, theta, None, 11, 0.5, True, 0)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


# (B, T, H, W, C): T = 32 on the tensor cores (T padded to 32) and on the
# CUDA cores (fp32), F not a multiple of 64 (a part-full last slice), F not a
# multiple of 8 (CUDA cores in bf16), T = 17, and the step's first shape at
# batch 8
K2_CARD = [(4, 32, 4, 4, 64), (3, 32, 3, 3, 40), (5, 8, 3, 3, 40), (2, 3, 3, 5, 7),
           (2, 17, 1, 1, 7), (8, 8, 14, 14, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("adj_fp32", [False, True], ids=["adj_xdtype", "adj_fp32"])
@pytest.mark.parametrize("dn", list(DTYPES))
@pytest.mark.parametrize("shape", K2_CARD, ids=str)
def test_propagate_kernel_equals_plain_on_card(shape, dn, adj_fp32):
    dev = _cuda()
    dt = DTYPES[dn]
    b, t = shape[:2]
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, device=dev, generator=g).to(dt)
    adj = torch.rand(b, t, t, device=dev, generator=g)
    adj = adj if adj_fp32 else adj.to(dt)
    tol = 8e-3 if dt == torch.bfloat16 else 1e-5     # a bf16 rounding flip
    for tr in (False, True):
        before = tracing.counters()["gcn_propagate"]
        got = gp._launch(adj, x, transpose=tr)
        again = gp._launch(adj, x, transpose=tr)
        assert tracing.counters()["gcn_propagate"] - before == 2
        assert got.shape == x.shape and got.dtype == dt
        assert torch.equal(got, again)
        assert _rel(got, gp.propagate_plain(adj, x, transpose=tr)) <= tol
