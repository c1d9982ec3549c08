"""Batched matmul with the JAX einsum's ``preferred_element_type=float32``
contract, for the kernels' plain versions.

The sum runs in at least fp32 (float64 for float64 inputs) and the result
is rounded to fp32; the gradients are formed the same way and cast back to
each input's dtype (JAX's ``dot_general`` transpose rule).  For fp32 and
bf16 inputs this is ordinary fp32 autograd; for float64 inputs it rounds
where the JAX package rounds, so CPU parity tests can run both in float64.
"""

from __future__ import annotations

import torch


class _BmmF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                                  torch.float32)
        ctx.acc = acc
        return torch.bmm(a.to(acc), b.to(acc)).float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        acc = ctx.acc
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g.to(acc), b.to(acc).transpose(1, 2)).float().to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.to(acc).transpose(1, 2), g.to(acc)).float().to(b.dtype)
        return ga, gb


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over a batch dim, summed in >= fp32, result fp32."""
    return _BmmF32.apply(a, b)
