"""First-conv channel inflation for non-RGB modalities (counterpart of
``video_graph_ssl_tpu/utils/inflate.py``).

Fine-tuning an RGB-pretrained network on optical flow (2 x new_length
input channels) or stacked RGB differences replaces the stem conv's weight
by its mean over the RGB input-channel axis, tiled to the new channel count
(reference visual_wrappers.py:214-235).  The port's weights are
``(cout, cin, *window)``, so the input channels are dim 1.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

State = Dict[str, torch.Tensor]


def find_first_conv(state_dict: State, old_in_channels: int = 3) -> Tuple[str, torch.Tensor]:
    """(name, weight) of the stem conv: the one conv weight (rank >= 4)
    with ``old_in_channels`` input channels.  Found by shape, as the JAX
    package finds it; none or several raise ``ValueError``."""
    hits = [(k, v) for k, v in state_dict.items()
            if k.endswith("weight") and v.dim() >= 4 and v.shape[1] == old_in_channels]
    if not hits:
        raise ValueError(f"no conv kernel with {old_in_channels} input channels found")
    if len(hits) > 1:
        raise ValueError(f"ambiguous stem conv: {[k for k, _ in hits]}")
    return hits[0]


def inflate_first_conv(state_dict: State, new_in_channels: int,
                       old_in_channels: int = 3) -> State:
    """A copy of ``state_dict`` (one model's, e.g. a pretrain checkpoint's
    ``state_dict``) whose stem conv weight has ``new_in_channels`` input
    channels: the mean over the old ones, tiled."""
    name, w = find_first_conv(state_dict, old_in_channels)
    mean = w.mean(dim=1, keepdim=True)
    out = dict(state_dict)
    out[name] = mean.repeat(1, new_in_channels, *([1] * (w.dim() - 2))).contiguous()
    return out
