"""Temporal-graph adjacency: similarity, row softmax, hop reweighting and
the relaxed-Bernoulli draw in one kernel.

Counterpart of ``video_graph_ssl_tpu/ops/pallas/graph_kernel.py``::

    sim = q k^T          (per clip, T x T, T <= 32, contracted over D)
    S   = softmax(sim)   (optionally band-masked: |i - j| < nei_size)
    p   = S * theta
    adj = sigmoid((logit(clip(p)) + logit(u)) / tau)   if sample, else p

On a CUDA tensor :func:`graph_adjacency` launches the hand-written kernels
in ``csrc/graph_adjacency.cu`` (partial similarities over splits of D,
then a per-row epilogue; :func:`adjacency_plan` is their launch plan, a
pure function); on a CPU tensor it runs
:func:`graph_adjacency_plain`, the plain PyTorch version (autograd through
torch ops) that the tests and ``chip_smoke.py`` hold the kernel to.

The noise ``u`` is either passed in (tests inject a draw) or drawn from
``seed``: in the kernel by Philox4x32-10 keyed by the seed with counter
(element, clip), in the plain version by a ``torch.Generator`` seeded with
it.  The two draws share a distribution, not bits.  ``rows=(clip0,
clips)`` places the call's B clips at ``[clip0, clip0 + B)`` of a global
batch of ``clips`` (one rank's rows under ``torch.distributed``): the
kernel counts clips from ``clip0``, the plain version draws the global
batch's noise and keeps those rows, so each rank draws its rows of the
one-process draw.

The backward (:func:`_adjacency_bwd`) is the closed form of the JAX
package's custom VJP, in torch ops on the small (B, T, T) tensors; dq and dk
are ``torch.bmm``.  ``u`` is a constant of the draw, as in
``RelaxedBernoulli.rsample``.

The forward is also the registered operator ``vgs_torch::graph_adjacency``
(``torch.library.custom_op``: the kernel for CUDA tensors, the plain version
for CPU ones, a fake that gives the (3, B, T, T) output's shape), which the
CUDA path of :func:`graph_adjacency` calls, so that ``torch.export`` keeps
the kernel in an exported graph (``export_model.py``).  A process that
loads such a graph imports this module first.

The forward, kernel or plain, runs under a ``graph_adjacency`` span
(``utils/tracing.py``); the closed-form backward runs outside it.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..utils import tracing
from . import _build
from .matmul import bmm_f32

EPS = 1e-6
MAX_T = 32
NUM_SMS = 132          # H100 SXM
THREADS = 128          # sim_partial_kernel's block
# blocks of the similarity launch to aim for: four per SM, so that each SM
# keeps tens of KB of loads in flight
TARGET_BLOCKS = 4 * NUM_SMS


Rows = Optional[Tuple[int, int]]


def global_rows(shape, rows: Rows) -> Tuple[tuple, int]:
    """(the global batch's shape, the first row) of a draw of ``shape``
    whose leading dim holds rows ``[clip0, clip0 + shape[0])`` of ``clips``."""
    if rows is None:
        return tuple(shape), 0
    clip0, clips = int(rows[0]), int(rows[1])
    if not 0 <= clip0 <= clips - shape[0]:
        raise ValueError(f"rows [{clip0}, {clip0 + shape[0]}) outside a batch of {clips}")
    return (clips, *shape[1:]), clip0


def draw_uniform(shape, seed: int, device, rows: Rows = None) -> torch.Tensor:
    """U(EPS, 1 - EPS) noise of the plain version, from a seeded generator;
    with ``rows``, those rows of the global batch's draw."""
    full, clip0 = global_rows(shape, rows)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0x7FFF_FFFF_FFFF_FFFF)
    u = torch.rand(full, generator=g, device=device, dtype=torch.float32)
    return (u * (1.0 - 2.0 * EPS) + EPS)[clip0:clip0 + shape[0]]


def _band_mask(sim: torch.Tensor, nei_size: int) -> torch.Tensor:
    t = sim.shape[-1]
    if not 0 < nei_size < t:
        return sim
    idx = torch.arange(t, device=sim.device)
    band = (idx[:, None] - idx[None, :]).abs() < nei_size
    return sim.masked_fill(~band, float("-inf"))


def relaxed_bernoulli(p: torch.Tensor, u: torch.Tensor, temperature: float,
                      eps: float = EPS) -> torch.Tensor:
    """``sigmoid((logit(clip(p, eps, 1 - eps)) + logit(u)) / temperature)``."""
    pc = p.clamp(eps, 1.0 - eps)
    logits = (torch.log(pc) - torch.log1p(-pc)
              + torch.log(u) - torch.log1p(-u))
    return torch.sigmoid(logits / temperature)


def _adjacency_fwd_plain(q, k, theta, u, seed, temperature, sample, nei_size,
                         rows: Rows = None) -> Tuple[torch.Tensor, ...]:
    """(adj, S, p) in fp32, the same outputs as the kernel.  The similarity
    is summed in at least fp32 and rounded to fp32 (the JAX einsum's
    ``preferred_element_type``)."""
    sim = bmm_f32(q, k.transpose(1, 2))
    s = torch.softmax(_band_mask(sim, nei_size), dim=-1)
    p = s * theta.float()[None]
    if not sample:
        return p, s, p
    if u is None:
        u = draw_uniform(p.shape, seed, p.device, rows)
    return relaxed_bernoulli(p, u, temperature), s, p


def graph_adjacency_plain(q: torch.Tensor, k: torch.Tensor,
                          theta: torch.Tensor, seed: int = 0,
                          temperature: float = 1.0, sample: bool = True,
                          u: Optional[torch.Tensor] = None,
                          nei_size: int = 0, rows: Rows = None) -> torch.Tensor:
    """Plain PyTorch version; gradients by autograd through torch ops."""
    return _adjacency_fwd_plain(q, k, theta, u, seed, temperature, sample,
                                nei_size, rows)[0]


def _check(q, k, theta, u) -> None:
    if q.dim() != 3 or q.shape != k.shape:
        raise ValueError(f"graph_adjacency: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} must both be (B, T, D)")
    b, t, _ = q.shape
    if not 1 <= t <= MAX_T:
        raise ValueError(f"graph_adjacency: T={t} outside [1, {MAX_T}]")
    if q.dtype != k.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"graph_adjacency: q/k dtypes {q.dtype}/{k.dtype} "
                        "(want one of fp32, bf16)")
    if tuple(theta.shape) != (t, t):
        raise ValueError(f"graph_adjacency: theta {tuple(theta.shape)} != ({t}, {t})")
    tensors = [q, k, theta] + ([u] if u is not None else [])
    if not all(x.is_cuda and x.device == q.device for x in tensors):
        raise ValueError("graph_adjacency: all tensors must be on one CUDA device")
    if u is not None and tuple(u.shape) != (b, t, t):
        raise ValueError(f"graph_adjacency: u {tuple(u.shape)} != ({b}, {t}, {t})")


class AdjacencyPlan(NamedTuple):
    """The two launches of one K1 call (``csrc/graph_adjacency.cu``)."""
    vec: int            # elements per load: 16 bytes, or 1 where D is ragged
    tile: int           # a thread's pairs: tile x tile (2, 4 or 8)
    tiles: int          # tiles per clip, ceil(T / tile)^2
    lanes: int          # threads per tile in a block: THREADS / tiles
    vectors: int        # loads per row of q or k: D / vec
    splits: int         # blocks per clip, each over per_split vectors
    per_split: int
    blocks: int         # sim_partial_kernel: B * splits
    epilogue_blocks: int  # adjacency_epilogue_kernel: a warp per row, 8 a block
    scratch: int        # fp32 partial sims: splits * B * T * T


def adjacency_plan(b: int, t: int, d: int, dtype: torch.dtype,
                   aligned: bool = True) -> AdjacencyPlan:
    """Split D so that B * splits reaches ``TARGET_BLOCKS``, but into no
    more splits than leave each about one vector per lane of its tile."""
    esize = dtype.itemsize
    vec = 16 // esize if aligned and (d * esize) % 16 == 0 else 1
    tile = 2 if t <= 2 else 4 if t <= 4 else 8
    tiles = (-(-t // tile)) ** 2
    lanes = THREADS // tiles
    vectors = d // vec
    splits = max(1, min(-(-TARGET_BLOCKS // b), -(-vectors // lanes)))
    per_split = -(-vectors // splits)
    splits = -(-vectors // per_split)     # no empty split
    return AdjacencyPlan(vec, tile, tiles, lanes, vectors, splits, per_split,
                         b * splits, -(-b * t // 8), b * splits * t * t)


@functools.lru_cache(maxsize=64)
def _cached_plan(b, t, d, dtype, aligned) -> AdjacencyPlan:
    return adjacency_plan(b, t, d, dtype, aligned)


def adjacency_fwd_kernel(q, k, theta, u, seed, temperature, sample, nei_size,
                         u_out: Optional[torch.Tensor] = None, rows: Rows = None
                         ) -> torch.Tensor:
    """One call (two launches) -> adj, S, p stacked, (3, B, T, T) fp32: the
    first planes of one (3 + splits, B, T, T) buffer whose last planes take
    the partial similarities.  ``u_out`` (B,T,T fp32), when given, receives
    the noise the kernel drew; ``rows`` offsets the draw's clip counter."""
    _check(q, k, theta, u)
    q, k = q.contiguous(), k.contiguous()
    if theta.dtype != torch.float32 or not theta.is_contiguous():
        theta = theta.float().contiguous()
    if u is not None and (u.dtype != torch.float32 or not u.is_contiguous()):
        u = u.float().contiguous()
    b, t, d = q.shape
    clip0 = global_rows(q.shape, rows)[1]
    if u_out is not None and (u_out.shape != (b, t, t) or u_out.dtype != torch.float32
                              or not u_out.is_contiguous() or u_out.device != q.device):
        raise ValueError("graph_adjacency: u_out must be a contiguous fp32 "
                         f"(B, T, T) tensor on {q.device}")
    plan = _cached_plan(b, t, d, q.dtype,
                        q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0)
    buf = torch.empty((3 + plan.splits, b, t, t), device=q.device, dtype=torch.float32)
    adj, s, p = buf[:3].unbind(0)
    code = _build.library().vgs_graph_adjacency(
        q.data_ptr(), k.data_ptr(), theta.data_ptr(),
        u.data_ptr() if u is not None else None,
        adj.data_ptr(), s.data_ptr(), p.data_ptr(),
        u_out.data_ptr() if u_out is not None else None, buf.data_ptr() + 12 * b * t * t,
        b, t, d, int(q.dtype == torch.bfloat16),
        int(seed) & 0xFFFF_FFFF_FFFF_FFFF, clip0, float(temperature), int(sample),
        int(nei_size), plan.vec, plan.tile, plan.splits, plan.per_split,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "vgs_graph_adjacency")
    tracing.count("graph_adjacency")
    return buf[:3]


def _signed64(seed: int) -> int:
    """``seed``'s low 64 bits as the signed int an operator's schema takes
    (the kernel masks them back, the plain version keeps the low 63)."""
    s = int(seed) & 0xFFFF_FFFF_FFFF_FFFF
    return s - (1 << 64) if s >= 1 << 63 else s


@torch.library.custom_op("vgs_torch::graph_adjacency", mutates_args=(), device_types="cuda")
def adjacency_op(q: torch.Tensor, k: torch.Tensor, theta: torch.Tensor,
                 u: Optional[torch.Tensor], seed: int, temperature: float, sample: bool,
                 nei_size: int, clip0: int, clips: int) -> torch.Tensor:
    """adj, S, p stacked (3, B, T, T) fp32; ``clips`` 0: no rows."""
    return adjacency_fwd_kernel(q, k, theta, u, seed, temperature, sample, nei_size,
                                rows=(clip0, clips) if clips else None)


@adjacency_op.register_kernel("cpu")
def _adjacency_op_cpu(q, k, theta, u, seed, temperature, sample, nei_size, clip0, clips):
    return torch.stack(_adjacency_fwd_plain(q, k, theta, u, seed, temperature, sample,
                                            nei_size, (clip0, clips) if clips else None))


@adjacency_op.register_fake
def _adjacency_op_fake(q, k, theta, u, seed, temperature, sample, nei_size, clip0, clips):
    b, t, _ = q.shape
    return q.new_empty((3, b, t, t), dtype=torch.float32)


def adjacency_fwd_op(q, k, theta, u, seed, temperature, sample, nei_size,
                     rows: Rows = None) -> torch.Tensor:
    """The forward through ``vgs_torch::graph_adjacency`` -> (3, B, T, T)."""
    clip0, clips = rows if rows is not None else (0, 0)
    return adjacency_op(q, k, theta, u, _signed64(seed), float(temperature), bool(sample),
                        int(nei_size), int(clip0), int(clips))


def _adjacency_bwd(g, q, k, theta, s, p, adj, temperature, sample):
    """Closed-form VJP (the JAX package's ``_graph_adjacency_bwd``)."""
    g = g.float()
    if sample:
        pc = p.clamp(EPS, 1.0 - EPS)
        dp = g * adj * (1.0 - adj) / temperature / (pc * (1.0 - pc))
        # zero gradient where p was clipped (saturated sample)
        dp = torch.where((p > EPS) & (p < 1.0 - EPS), dp, torch.zeros_like(dp))
    else:
        dp = g
    ds = dp * theta.float()[None]
    dsim = s * (ds - (ds * s).sum(dim=-1, keepdim=True))
    dq = torch.bmm(dsim, k.float())
    dk = torch.bmm(dsim.transpose(1, 2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype)


class GraphAdjacencyFn(torch.autograd.Function):
    """Forward through ``fwd`` (the kernel, or the plain forward in tests of
    the closed-form backward), backward in closed form."""

    @staticmethod
    def forward(ctx, fwd: Callable, q, k, theta, u, seed, temperature,
                sample, nei_size):
        with tracing.span("graph_adjacency"):
            adj, s, p = fwd(q, k, theta, u, seed, temperature, sample, nei_size)
        ctx.save_for_backward(q, k, theta, s, p, adj)
        ctx.temperature, ctx.sample = temperature, sample
        return adj

    @staticmethod
    def backward(ctx, g):
        q, k, theta, s, p, adj = ctx.saved_tensors
        dq, dk = _adjacency_bwd(g, q, k, theta, s, p, adj, ctx.temperature,
                                ctx.sample)
        return None, dq, dk, None, None, None, None, None, None


def graph_adjacency(q: torch.Tensor, k: torch.Tensor, theta: torch.Tensor,
                    seed: int = 0, temperature: float = 1.0,
                    sample: bool = True, u: Optional[torch.Tensor] = None,
                    nei_size: int = 0, rows: Rows = None) -> torch.Tensor:
    """Sampled adjacency (B,T,T) fp32 from q, k (B,T,D); the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors.  ``rows`` (clip0,
    clips): the clips' place in a global batch, for the noise draw."""
    if q.device.type == "cpu" and k.device.type == "cpu":
        with tracing.span("graph_adjacency"):
            return graph_adjacency_plain(q, k, theta, seed, temperature, sample,
                                         u, nei_size, rows)
    return GraphAdjacencyFn.apply(functools.partial(adjacency_fwd_op, rows=rows), q, k,
                                  theta, u, seed, temperature, sample, nei_size)
