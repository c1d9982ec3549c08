"""The graph block with the frame axis sharded over ranks, exchanged in
rings (counterpart of ``video_graph_ssl_tpu/parallel/sequence.py``).

With T split over the P ranks of a ``torch.distributed`` process group
(each rank holds frames ``[rank * Tl, (rank + 1) * Tl)``, Tl = T / P):

* :func:`ring_similarity` -- sim[b, i, j] = q_i . k_j for this rank's rows
  i and all columns j, fp32.  The k blocks rotate; each of the P steps
  writes one (B, Tl, Tl) column block (``bmm_f32``: fp32 sums, as JAX's
  einsum, which runs outside Pallas).
* :func:`ring_propagate` -- out[b, i] = sum_j adj[b, i, j] support[b, j]
  for this rank's rows.  The support blocks rotate; each step's product is
  a square (B, Tl, Tl) column block of adj times one (B, Tl, ...) block:
  kernel K2 (``ops/gcn_propagate.py``) on CUDA tensors, its plain version
  on CPU tensors.  The block product runs in fp32 on the block rounded to
  the support's dtype (JAX's ``cols.astype(support.dtype)``) and the
  support block widened to fp32, so each partial sum is exact JAX
  semantics: products of bf16 values are exact in fp32, summed in fp32,
  cast once at the end.  K2's bf16 route would round every block product
  to bf16 before the sum, which JAX does not do.
* :func:`rowfold_bernoulli_sample` -- the relaxed-Bernoulli draw of this
  rank's rows: rows ``[row0, row0 + Tl)`` of one (B, T, T) U(eps, 1 - eps)
  draw from a generator seeded with ``seed`` on the tensor's device
  (``ops/graph_kernel.py:draw_uniform``), so the sampled adjacency is the
  same for every P, P = 1 included.  JAX keys its rows with threefry
  ``fold_in``; the port keeps the property its own way, and ``u`` takes
  injected draws (tests feed it JAX's).
* :func:`sp_graph_aug_apply` -- the ``TemporalGraphAug`` forward over a
  T-sharded activation from these pieces, on the weights of a port
  ``TemporalGraphAug`` (so the two paths share checkpoints); and
  :func:`graph_aug_sequence_parallel`, which takes the global clip and
  returns this rank's frames of the output.

Ring steps send to the neighbour with ``batch_isend_irecv``: rank r sends
to r - 1 and receives from r + 1, as JAX's ``ppermute`` (``_ring_perm``);
the backward's partial sums travel the other way.  Under gloo a CUDA block
goes through a pinned host copy on each side of the exchange (gloo does
not send CUDA tensors point to point); that changes the transport, not the
computation: every product stays on the card.  :data:`sent_bytes` counts
the bytes this process sent.

Gradients: each ring is a ``torch.autograd.Function`` whose backward runs
the transposed ring.  ``ring_similarity``: dq from the k blocks rotating
again, dk as partial sums rotating back to their owner.
``ring_propagate``: d_support through K2's transpose route, the partial
sums rotating back; d_adj as the (B, Tl, Tl) block products of the
cotangent and the rotating support blocks (a library GEMM, as the JAX
package leaves that contraction to XLA and the single-device K2 backward
does).  Every rank must run the backward, in the same order.  The weight
gradients of the q/k embeddings and the GCN transforms are each rank's
share: sum them over the group (JAX's ``shard_map`` sums the cotangents of
its replicated inputs).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from ..ops import gcn_propagate as _k2
from ..ops.graph_kernel import EPS, draw_uniform, relaxed_bernoulli
from ..ops.matmul import bmm_f32
from ..ops.temporal_graph import TemporalGraphAug, _linear_cl, _theta

# bytes this process has sent in ring steps since the last reset
sent_bytes = 0


def _ring(group) -> Tuple[int, int]:
    """(P, this rank's place in the group); (1, 0) without a process group."""
    if not (tdist.is_available() and tdist.is_initialized()):
        return 1, 0
    return tdist.get_world_size(group), tdist.get_rank(group)


def _exchange(sends: Sequence[Tuple[torch.Tensor, int]], group) -> List[torch.Tensor]:
    """Each ``(tensor, step)`` goes to the rank ``step`` places on (-1:
    JAX's ``ppermute`` direction) while its counterpart comes from the rank
    ``-step`` places on; all in one ``batch_isend_irecv``.  Returns the
    received tensors."""
    global sent_bytes
    p, me = _ring(group)
    if p == 1:
        return [t for t, _ in sends]
    host = tdist.get_backend(group) == "gloo"
    ops, recvs = [], []
    for t, step in sends:
        t = t.contiguous()
        send = t
        if host and t.is_cuda:
            send = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        recv = torch.empty_like(send)
        dst, src = (me + step) % p, (me - step) % p
        if group is not None:
            dst, src = tdist.get_global_rank(group, dst), tdist.get_global_rank(group, src)
        ops += [tdist.P2POp(tdist.isend, send, dst, group),
                tdist.P2POp(tdist.irecv, recv, src, group)]
        recvs.append((recv, t.device))
        sent_bytes += t.numel() * t.element_size()
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(device) if r.device != device else r for r, device in recvs]


def _cols(a: torch.Tensor, j: int, tl: int) -> torch.Tensor:
    return a[:, :, j * tl:(j + 1) * tl]


def _acc_dtype(*ts: torch.Tensor) -> torch.dtype:
    """fp32, or float64 where an input is float64 (CPU tests)."""
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) else torch.float32


def block_product(cols: torch.Tensor, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """One ring step's product, fp32 (B, Tl, ...): ``cols`` (B, Tl, Tl)
    rounded to ``x``'s dtype, times (``transpose``: the transpose of) the
    block ``x`` (B, Tl, ...), summed in fp32.  K2 on CUDA tensors, its
    plain version on CPU tensors."""
    acc = _acc_dtype(x)
    a, xf = cols.to(x.dtype).to(acc), x.to(acc)
    if x.is_cuda:
        return _k2._launch(a, xf, transpose)
    return _k2.propagate_plain(a, xf, transpose)


class _RingSimilarity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, group):
        p, me = _ring(group)
        b, tl, _ = q.shape
        out = q.new_empty((b, tl, tl * p), dtype=torch.float32)
        kbuf = k
        for s in range(p):
            _cols(out, (me + s) % p, tl).copy_(bmm_f32(q, kbuf.transpose(1, 2)))
            if s < p - 1:
                kbuf, = _exchange([(kbuf, -1)], group)
        ctx.save_for_backward(q, k)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        group = ctx.group
        p, me = _ring(group)
        tl = q.shape[1]
        acc_t = _acc_dtype(q, k)
        g = g.to(acc_t)
        dq = torch.zeros(q.shape, dtype=acc_t, device=q.device)
        kbuf = k
        dk = torch.zeros(k.shape, dtype=acc_t, device=k.device)
        for s in range(p):
            dq += torch.bmm(_cols(g, (me + s) % p, tl), kbuf.to(acc_t))
            # the partial dk of block (me - s - 1) % P, which ends on its owner
            dk += torch.bmm(_cols(g, (me - s - 1) % p, tl).transpose(1, 2), q.to(acc_t))
            if s < p - 1:
                kbuf, dk = _exchange([(kbuf, -1), (dk, 1)], group)
        return dq.to(q.dtype), dk.to(k.dtype), None


def ring_similarity(q: torch.Tensor, k: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's similarity rows against all columns via a k-block ring.
    ``q``/``k``: (B, Tl, D) frame shards; returns (B, Tl, T) fp32."""
    return _RingSimilarity.apply(q, k, group)


class _RingPropagate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, adj_rows, support, group):
        p, me = _ring(group)
        tl = support.shape[1]
        acc = torch.zeros(support.shape, dtype=_acc_dtype(support), device=support.device)
        buf = support
        for s in range(p):
            acc += block_product(_cols(adj_rows, (me + s) % p, tl), buf)
            if s < p - 1:
                buf, = _exchange([(buf, -1)], group)
        ctx.save_for_backward(adj_rows, support)
        ctx.group = group
        return acc.to(support.dtype)

    @staticmethod
    def backward(ctx, g):
        adj_rows, support = ctx.saved_tensors
        group = ctx.group
        p, me = _ring(group)
        b, tl = support.shape[:2]
        acc_t = _acc_dtype(support)
        g = g.contiguous()
        gf = g.to(acc_t).reshape(b, tl, -1)
        dadj = torch.zeros(adj_rows.shape, dtype=acc_t, device=adj_rows.device)
        dsup = torch.zeros(support.shape, dtype=acc_t, device=support.device)
        buf = support
        for s in range(p):
            j = (me + s) % p
            _cols(dadj, j, tl).copy_(torch.bmm(gf, buf.to(acc_t).reshape(b, tl, -1)
                                               .transpose(1, 2)))
            # the partial d_support of block (me - s - 1) % P: K2 transposed
            dsup += block_product(_cols(adj_rows, (me - s - 1) % p, tl), g, transpose=True)
            if s < p - 1:
                buf, dsup = _exchange([(buf, -1), (dsup, 1)], group)
        return dadj.to(adj_rows.dtype), dsup.to(support.dtype), None


def ring_propagate(adj_rows: torch.Tensor, support: torch.Tensor, group=None) -> torch.Tensor:
    """out[b, i] = sum_j adj[b, i, j] support[b, j] for this rank's rows i.
    ``adj_rows`` (B, Tl, T); ``support`` (B, Tl, ...) this rank's frames;
    returns ``support``'s shape and dtype (fp32 partial sums, cast once)."""
    return _RingPropagate.apply(adj_rows, support, group)


def rowfold_bernoulli_sample(seed: int, probs_rows: torch.Tensor, temperature: float,
                             row0: int, eps: float = EPS,
                             u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Relaxed-Bernoulli rsample of this rank's rows ``probs_rows`` (B, Tl,
    T), which are rows ``[row0, row0 + Tl)`` of the global adjacency: the
    noise is those rows of one (B, T, T) draw seeded with ``seed`` on the
    tensor's device, so the sample does not depend on P.  ``u`` (B, Tl, T)
    replaces the draw.  Reparameterised: gradients reach ``probs_rows``."""
    b, tl, t = probs_rows.shape
    if u is None:
        u = draw_uniform((b, t, t), seed, probs_rows.device)[:, row0:row0 + tl]
    return relaxed_bernoulli(probs_rows.float(), u.float(), temperature,
                             eps).to(probs_rows.dtype)


def _check_module(module: TemporalGraphAug) -> None:
    """What JAX's ring path supports: no bias, no BN, no frame mask."""
    from ..models.layers import BatchNorm

    if any(isinstance(m, torch.nn.Conv3d) and m.bias is not None for m in module.modules()):
        raise ValueError("sequence-parallel graph block: use_bias is not supported")
    if any(isinstance(m, BatchNorm) for m in module.modules()):
        raise ValueError("sequence-parallel graph block: bn_layer is not supported")
    if module.nei_size:
        raise ValueError("sequence-parallel graph block: mask_frame is not supported")


def sp_graph_aug_apply(module: TemporalGraphAug, x_local: torch.Tensor, *, group=None,
                       tem_len: int, sampler: str = "none", rng: Optional[int] = None,
                       noise: Optional[torch.Tensor] = None,
                       max_hop: Optional[int] = None, alpha: Optional[float] = None,
                       temperature: Optional[float] = None) -> torch.Tensor:
    """The ``TemporalGraphAug`` forward over this rank's frames ``x_local``
    (B, Tl, H, W, C) of a clip of ``tem_len`` frames, on ``module``'s
    weights, in its compute dtype (JAX's ``dtype``).  ``max_hop``,
    ``alpha`` and ``temperature`` default to the module's; the q/k pooling
    (JAX's ``sub_sample``/``max_pool``) is the module's own, frame-local.  ``sampler``: 'none' or
    'relaxed_bernoulli' (needs ``rng``, the seed of the draw, or ``noise``,
    this rank's rows of an injected U(eps, 1 - eps) draw).  Returns this
    rank's frames of the output."""
    _check_module(module)
    if sampler == "relaxed_bernoulli":
        if rng is None and noise is None:
            raise ValueError("relaxed_bernoulli sampler needs an rng")
    elif sampler != "none":
        raise ValueError(f"unsupported sequence-parallel sampler: {sampler}")
    dtype = module.dtype
    max_hop = module.max_hop if max_hop is None else max_hop
    alpha = module.alpha if alpha is None else alpha
    temperature = module.temperature if temperature is None else temperature
    _, me = _ring(group)
    b, tl = x_local.shape[:2]
    row0 = me * tl

    # 1. q/k embeddings: channel Dense + frame-local pool (the module's)
    g_q = module._embed_apply(module.g_q, x_local).reshape(b, tl, -1)
    g_k = module._embed_apply(module.g_k, x_local).reshape(b, tl, -1)

    # 2. similarity rows via the k ring; softmax over the complete row
    sim = torch.softmax(ring_similarity(g_q, g_k, group), dim=-1)

    # 3. this rank's rows of the (T, T) hop weights
    theta = _theta(tem_len, max_hop, float(alpha), str(x_local.device))[row0:row0 + tl]
    adj = sim * theta[None]

    # 4. the draw, the same for every P
    if sampler == "relaxed_bernoulli":
        adj = rowfold_bernoulli_sample(0 if rng is None else rng, adj, temperature, row0, u=noise)
    adj = adj.to(dtype)

    # 5. stacked skip-GCNs: frame-local transform, ring propagation
    out = x_local
    for gcn in module.gcns:
        support = _linear_cl(out, gcn.conv, dtype)
        out = ring_propagate(adj, support, group) + support
    return out


def graph_aug_sequence_parallel(module: TemporalGraphAug, x: torch.Tensor, group=None,
                                **kw) -> torch.Tensor:
    """Take this rank's frames of the global clip ``x`` (B, T, H, W, C) and
    run :func:`sp_graph_aug_apply` on them; returns this rank's frames
    ``[rank * T/P, (rank + 1) * T/P)`` of the output.  T must divide by the
    group's size."""
    t = x.shape[1]
    p, me = _ring(group)
    if t % p != 0:
        raise ValueError(f"T={t} not divisible by the process group's size {p}")
    tl = t // p
    return sp_graph_aug_apply(module, x[:, me * tl:(me + 1) * tl], group=group,
                              tem_len=t, **kw)
