"""GCN frame-axis propagation: ``out[b,i,h,w,c] = sum_j adj[b,i,j] x[b,j,h,w,c]``.

Counterpart of ``video_graph_ssl_tpu/ops/pallas/gcn_propagate.py``.  On a
CUDA tensor :func:`gcn_propagate` launches the hand-written kernel in
``csrc/gcn_propagate.cu`` (forward, and the backward's dx through the same
kernel on adj^T); on a CPU tensor it runs :func:`propagate_plain`, the plain
PyTorch version that the tests and ``chip_smoke.py`` hold the kernel to.
There is no fallback from the kernel to the plain version.

Contract (the JAX GCN's): the adjacency is cast to ``x.dtype``, products
accumulate in fp32, the result is cast back to ``x.dtype``.
"""

from __future__ import annotations

import torch

from . import _build
from .matmul import bmm_f32

# Kernel launches since the last reset (one per forward or dx backward).
launches = 0

MAX_T = 32


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
    """One kernel launch; adj is cast to x.dtype, both made contiguous."""
    global launches
    _check(adj, x)
    adj = adj.to(x.dtype).contiguous()
    x = x.contiguous()
    out = torch.empty_like(x)
    b, t = x.shape[:2]
    lib = _build.library()
    code = lib.vgs_gcn_propagate(
        adj.data_ptr(), x.data_ptr(), out.data_ptr(), b, t,
        x.numel() // (b * t), int(transpose), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "vgs_gcn_propagate")
    launches += 1
    return out


class _GcnPropagate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, adj, x):
        ctx.save_for_backward(adj, x)
        return _launch(adj, x, transpose=False)

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
