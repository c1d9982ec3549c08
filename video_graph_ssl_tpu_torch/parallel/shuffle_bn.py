"""ShuffleBN: the MoCo key pass with per-rank BN over a shuffled batch
(counterpart of ``video_graph_ssl_tpu/parallel/shuffle_bn.py``,
``TPU.SHUFFLE_BN True``).

The reference's guard against BN leaking the batch into the keys
(tools/train_video_contrast_dis.py:189-231), as the JAX package has it:

1. gather the key clips of all ranks and apply the step's permutation of
   the global batch, shared by every rank;
2. run the EMA encoder on this rank's rows of the shuffled batch with BN
   statistics of those rows only.  The JAX package hands every shard the
   same graph key, so each rank draws the graph noise of its local rows
   as clips 0.. (no global row offset);
3. gather the features and undo the permutation;
4. average the EMA encoder's updated BN running statistics over ranks
   (JAX's ``pmean`` of the new batch stats).
"""

from __future__ import annotations

import torch
from torch import nn

from . import dist
from .sync_bn import bn_buffers, per_rank_bn


@torch.no_grad()
def shuffle_bn_keys(ema: nn.Module, x_local: torch.Tensor, graph_seed: int,
                    perm: torch.Tensor) -> torch.Tensor:
    """Key features (B, dim) of the global batch in its own order, from this
    rank's clips ``x_local`` (b, ...) and ``perm`` (B,), a permutation of
    the global batch's rows that every rank passes alike."""
    b, w, r = x_local.shape[0], dist.world_size(), dist.rank()
    if perm.shape != (b * w,):
        raise ValueError(f"permutation of {tuple(perm.shape)} for a global batch of {b * w}")
    perm = perm.to(x_local.device)
    x_all = dist.all_gather_rows(x_local)
    mine = x_all.index_select(0, perm[r * b:(r + 1) * b])
    del x_all
    with per_rank_bn(ema):
        feat = ema(mine, graph_seed=graph_seed)
    feat_all = dist.all_gather_rows(feat)
    dist.average_(bn_buffers(ema))
    return feat_all.index_select(0, torch.argsort(perm))
