"""GCN frame-axis propagation: ``out[b,i,h,w,c] = sum_j adj[b,i,j] x[b,j,h,w,c]``.

Counterpart of ``video_graph_ssl_tpu/ops/pallas/gcn_propagate.py``.  On a
CUDA tensor :func:`gcn_propagate` launches the hand-written kernel in
``csrc/gcn_propagate.cu`` (forward, and the backward's dx through the same
kernel on adj^T); on a CPU tensor it runs :func:`propagate_plain`, the plain
PyTorch version that the tests and ``chip_smoke.py`` hold the kernel to.
There is no fallback from the kernel to the plain version.

Contract (the JAX GCN's): the adjacency is cast to ``x.dtype``, products
accumulate in fp32, the result is cast back to ``x.dtype``.  The kernel
takes adj in fp32 or in x's dtype and rounds it to x's dtype as it loads
it.  :func:`propagate_plan` is its launch plan, a pure function: the
tensor-core route for bf16 x with F a multiple of 8, the CUDA-core route
otherwise.

The forward is also the registered operator ``vgs_torch::gcn_propagate``
(``torch.library.custom_op``: the kernel for CUDA tensors, the plain version
for CPU ones, a fake that gives the output's shape), which the CUDA path
calls, so that ``torch.export`` keeps the kernel in an exported graph
(``export_model.py``).  A process that loads such a graph imports this
module first.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .matmul import bmm_f32

# Kernel launches since the last reset (one per forward or dx backward).
launches = 0

MAX_T = 32
TC_WARPS, TC_COLS, TC_STAGES = 4, 64, 4     # csrc/gcn_propagate.cu
TC_ROW = TC_COLS + 8          # elements per staged row (padded)
# items of a warp's run: the ring's length, so a run's loads are all in
# flight at once; longer runs (fewer warps) measured slower at every step
# shape on the H100, a single item slower too
TC_RUN = 4
SIMT_THREADS = 256


class PropagatePlan(NamedTuple):
    """One K2 launch (``csrc/gcn_propagate.cu``)."""
    route: str        # "tc" (bf16 tensor cores) or "simt" (CUDA cores)
    kpad: int         # tc: T padded to the MMA tile (16 or 32)
    items: int        # tc: (clip, 64-column slice) pairs; simt: (clip, vector)
    per_warp: int     # tc: a warp's run of consecutive items
    blocks: int
    threads: int
    smem_bytes: int   # tc: per warp a zero row and TC_STAGES slices of T rows x 72 bf16
    vec: int          # elements per thread: simt 4 (fp32, 16 bytes) or 1; tc 8


def propagate_plan(b: int, t: int, f: int, dtype: torch.dtype,
                   aligned: bool = True) -> PropagatePlan:
    """tc for bf16 with F a multiple of 8 (16-byte aligned): a warp per
    run of TC_RUN consecutive (clip, 64-column slice) items; simt
    otherwise, a thread per vector of columns."""
    if dtype == torch.bfloat16 and f % 8 == 0 and aligned:
        items = b * -(-f // TC_COLS)
        smem = TC_WARPS * (1 + TC_STAGES * t) * TC_ROW * 2
        return PropagatePlan("tc", 16 if t <= 16 else 32, items, TC_RUN,
                             -(-items // (TC_RUN * TC_WARPS)), TC_WARPS * 32, smem, 8)
    vec = 4 if dtype == torch.float32 and aligned and f % 4 == 0 else 1
    items = b * (f // vec)
    return PropagatePlan("simt", 0, items, 0, -(-items // SIMT_THREADS), SIMT_THREADS, 0, vec)


@functools.lru_cache(maxsize=64)
def _cached_plan(b, t, f, dtype, aligned) -> PropagatePlan:
    return propagate_plan(b, t, f, dtype, aligned)


def propagate_plain(adj: torch.Tensor, x: torch.Tensor,
                    transpose: bool = False) -> torch.Tensor:
    """Plain PyTorch version: adj (B,T,T), x (B,T,H,W,C) -> (B,T,H,W,C).

    Products are summed in at least fp32 and the sum is rounded to fp32
    before the cast back (the JAX einsum's ``preferred_element_type``)."""
    b, t = x.shape[:2]
    a = adj.to(x.dtype)
    if transpose:
        a = a.transpose(1, 2)
    out = bmm_f32(a, x.reshape(b, t, -1))
    return out.to(x.dtype).reshape(x.shape)


def _check(adj: torch.Tensor, x: torch.Tensor) -> None:
    if x.dim() < 3:
        raise ValueError(f"gcn_propagate: x must be (B, T, ...), got {tuple(x.shape)}")
    b, t = x.shape[:2]
    if tuple(adj.shape) != (b, t, t):
        raise ValueError(f"gcn_propagate: adj {tuple(adj.shape)} does not "
                         f"match x {tuple(x.shape)}")
    if not 1 <= t <= MAX_T:
        raise ValueError(f"gcn_propagate: T={t} outside [1, {MAX_T}]")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gcn_propagate: x dtype {x.dtype} (want fp32 or bf16)")
    if not (x.is_cuda and adj.is_cuda and x.device == adj.device):
        raise ValueError("gcn_propagate: adj and x must be on one CUDA device")


def _launch(adj: torch.Tensor, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    """One kernel launch.  adj is read in fp32 or x's dtype (other dtypes
    are cast to fp32 first) and rounded to x's dtype in the kernel."""
    global launches
    _check(adj, x)
    if adj.dtype not in (torch.float32, x.dtype):
        adj = adj.float()
    adj, x = adj.contiguous(), x.contiguous()
    out = torch.empty_like(x)
    b, t = x.shape[:2]
    f = x.numel() // (b * t)
    plan = _cached_plan(b, t, f, x.dtype, x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    code = _build.library().vgs_gcn_propagate(
        adj.data_ptr(), x.data_ptr(), out.data_ptr(), b, t, f, int(transpose),
        int(x.dtype == torch.bfloat16), int(adj.dtype == torch.float32),
        int(plan.route == "tc"), plan.kpad, plan.blocks, plan.per_warp, plan.vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "vgs_gcn_propagate")
    launches += 1
    return out


@torch.library.custom_op("vgs_torch::gcn_propagate", mutates_args=(), device_types="cuda")
def propagate_op(adj: torch.Tensor, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    """(B, T, ...) in x's dtype, contiguous."""
    return _launch(adj, x, transpose)


@propagate_op.register_kernel("cpu")
def _propagate_op_cpu(adj, x, transpose):
    return propagate_plain(adj, x, transpose).contiguous()


@propagate_op.register_fake
def _propagate_op_fake(adj, x, transpose):
    return x.new_empty(x.shape)


class _GcnPropagate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, adj, x):
        ctx.save_for_backward(adj, x)
        return propagate_op(adj, x, False)

    @staticmethod
    def backward(ctx, g):
        adj, x = ctx.saved_tensors
        dadj = dx = None
        g = g.contiguous()
        if ctx.needs_input_grad[1]:
            dx = _launch(adj, g, transpose=True)
        if ctx.needs_input_grad[0]:
            b, t = x.shape[:2]
            # dadj[b,i,j] = sum_f g[b,i,f] x[b,j,f]: a library GEMM, as the
            # JAX package leaves this contraction to XLA.
            dadj = torch.bmm(g.reshape(b, t, -1),
                             x.reshape(b, t, -1).transpose(1, 2)).to(adj.dtype)
        return dadj, dx


def gcn_propagate(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Frame-axis propagation; the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if x.device.type == "cpu" and adj.device.type == "cpu":
        return propagate_plain(adj, x)
    return _GcnPropagate.apply(adj, x)
