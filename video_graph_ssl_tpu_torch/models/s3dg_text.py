"""Text-video S3D-G (MIL-NCE): a gated S3D video tower and a sentence-
embedding text tower, counterpart of ``video_graph_ssl_tpu/models/
s3dg_text.py`` (the reference's unexported backbone_3d/s3dg.py:238-331).

Module names are the MIL-NCE state-dict names (the public
``s3d_howto100m.pth`` keys; JAX ``utils/torch_interop.py:
convert_torch_s3dg_text`` reads them): ``conv1.conv1.weight``,
``conv_2c.conv2.weight``, ``mixed_3b.conv_b1_b.bn2.running_var``,
``mixed_4b.gating_b2.fc.bias``, ``gating.fc.weight``, ``fc.weight``,
``text_module.word_embd.weight``, ``text_module.fc1.weight``, so such a
state dict loads with ``load_state_dict(strict=True)`` once torch BN's
``num_batches_tracked`` counters are dropped (:func:`milnce_names`): the
port's counterpart of ``convert_torch_s3dg_text``.

The video tower: the space-to-depth stem (clips (B, T, H, W, C) -> (B, T/2,
H/2, W/2, 8C), a (2, 4, 4) / 1 conv with pads (1, 2, 2), then the ``[1:,
1:, 1:]`` crop; T, H and W even) or the standard (3, 7, 7) / 2 one; conv
1x1x1 and the separable 3x3x3 pair; feature gating; the Inception stack
with a gate on every branch; a joint-embedding ``fc``.  The four stage pools
are TF "SAME" (JAX ``i3d._same_max_pool``): on CUDA tensors their backward
is kernel K4; each branch pool is torch's symmetric 3x3x3 / 1, padding 1,
whose backward is kernel K3 (``ops/maxpool.max_pool3d``).  Every BN is
torch-default (eps 1e-5, flax momentum 0.9) computed in fp32; the gates'
Dense, the head and the whole text tower run in fp32.

The text tower's max over words takes every word, the padding's ReLU(fc1(
embed(0))) included, as the reference does: a real semantic of the MIL-NCE
weights, not masked.  Tokenizing is host-side (:func:`tokenize`).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.torch_names import S3D_STAGE_INDEX
from .layers import BatchNorm, max_pool_3d
from .s3d import _MIXED_SPECS, to_bthwc, to_ncdhw

# the Inception blocks in order, and their (b0, b1, b2, b3) channel plan
MIXED = tuple(S3D_STAGE_INDEX)
MIXED_SPECS = {name: _MIXED_SPECS[idx] for name, idx in S3D_STAGE_INDEX.items()}
# the stage pools after conv1, conv_2c, mixed_3c and mixed_4f: (window, stride)
STAGE_POOLS = {"conv1": ((1, 3, 3), (1, 2, 2)), "conv_2c": ((1, 3, 3), (1, 2, 2)),
               "mixed_3c": ((3, 3, 3), (2, 2, 2)), "mixed_4f": ((2, 2, 2), (2, 2, 2))}


def _triple(v) -> Tuple[int, int, int]:
    return tuple(int(i) for i in v) if isinstance(v, (tuple, list)) else (int(v),) * 3


def space_to_depth_3d(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T/2, H/2, W/2, 8C), JAX's channel order."""
    b, t, h, w, c = x.shape
    x = x.reshape(b, t // 2, 2, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, t // 2, h // 2, w // 2, 8 * c)


class STConv(nn.Module):
    """conv + BN + ReLU, or with ``separable`` (and a temporal kernel above
    1) a spatial (1, k, k) conv + BN + ReLU then a temporal (k, 1, 1) one
    (``conv1``/``bn1``, ``conv2``/``bn2``; JAX ``STConv``, reference
    STConv3D)."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0,
                 separable: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        (kt, kh, kw), (st, sh, sw), (pt, ph, pw) = (_triple(v) for v in (kernel, stride,
                                                                        padding))
        self.separable = separable and kt != 1
        if self.separable:
            self.conv1 = nn.Conv3d(cin, cout, (1, kh, kw), (1, sh, sw), (0, ph, pw), bias=False)
            self.bn1 = BatchNorm(cout, 0.9, 1e-5)
            self.conv2 = nn.Conv3d(cout, cout, (kt, 1, 1), (st, 1, 1), (pt, 0, 0), bias=False)
            self.bn2 = BatchNorm(cout, 0.9, 1e-5)
        else:
            self.conv1 = nn.Conv3d(cin, cout, (kt, kh, kw), (st, sh, sw), (pt, ph, pw),
                                   bias=False)
            self.bn1 = BatchNorm(cout, 0.9, 1e-5)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        pairs = [(self.conv1, self.bn1)] + ([(self.conv2, self.bn2)] if self.separable else [])
        for conv, bn in pairs:
            x = F.conv3d(x.to(dt), conv.weight.to(dt), None, conv.stride, conv.padding)
            x = F.relu(bn(x).to(dt))
        return x


class SelfGating(nn.Module):
    """S3D-G feature gating: x times sigmoid(fc(the clip's mean)) per
    channel, the gate in fp32, cast to x's dtype (JAX ``SelfGating``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self.fc(x.float().mean(dim=(2, 3, 4)))).to(x.dtype)
        return x * w[:, :, None, None, None]


class TextInceptionBlock(nn.Module):
    """1x1x1 | 1x1x1 -> separable 3x3x3 | 1x1x1 -> separable 3x3x3 |
    3x3x3 / 1 max pool -> 1x1x1, a gate on each branch (JAX
    ``TextInceptionBlock``)."""

    def __init__(self, cin: int, b0: int, b1: Sequence[int], b2: Sequence[int], b3: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        kw = dict(dtype=dtype)
        self.conv_b0 = STConv(cin, b0, 1, **kw)
        self.conv_b1_a = STConv(cin, b1[0], 1, **kw)
        self.conv_b1_b = STConv(b1[0], b1[1], 3, padding=1, separable=True, **kw)
        self.conv_b2_a = STConv(cin, b2[0], 1, **kw)
        self.conv_b2_b = STConv(b2[0], b2[1], 3, padding=1, separable=True, **kw)
        self.conv_b3_b = STConv(cin, b3, 1, **kw)
        for i, c in enumerate((b0, b1[1], b2[1], b3)):
            setattr(self, f"gating_b{i}", SelfGating(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.conv_b0(x), self.conv_b1_b(self.conv_b1_a(x)),
                self.conv_b2_b(self.conv_b2_a(x)),
                # the branch pool: torch's MaxPool3d(3, 1, padding=1), not SAME
                self.conv_b3_b(max_pool_3d(x, 3, 1, 1))]
        outs = [getattr(self, f"gating_b{i}")(o) for i, o in enumerate(outs)]
        return torch.cat(outs, dim=1)

    @staticmethod
    def out_channels(b0: int, b1: Sequence[int], b2: Sequence[int], b3: int) -> int:
        return b0 + b1[1] + b2[1] + b3


class SentenceEmbedding(nn.Module):
    """Word tokens (B, max_words), 0 the padding -> (B, embd_dim): embedding,
    ReLU(fc1) per word, max over every word, fc2; fp32 (JAX
    ``SentenceEmbedding``)."""

    def __init__(self, embd_dim: int = 512, num_embeddings: int = 66250,
                 word_embedding_dim: int = 300, output_dim: int = 2048):
        super().__init__()
        self.word_embd = nn.Embedding(num_embeddings, word_embedding_dim)
        self.fc1 = nn.Linear(word_embedding_dim, output_dim)
        self.fc2 = nn.Linear(output_dim, embd_dim)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.fc1(self.word_embd(token_ids.long())))
        return self.fc2(h.max(dim=1).values)


def build_word_to_token(vocab: Sequence[str]) -> Dict[str, int]:
    """word -> id, 1-based (0 is the padding), the reference's dict.npy
    convention."""
    return {w: i + 1 for i, w in enumerate(vocab)}


def tokenize(sentences: List[str], word_to_token: Dict[str, int],
             max_words: int = 16) -> np.ndarray:
    """Host-side tokenizer: lower-cased ``[\\w']+`` words in the vocabulary,
    the first ``max_words``, zero-padded (B, max_words) int32."""
    out = np.zeros((len(sentences), max_words), np.int32)
    for i, sent in enumerate(sentences):
        words = re.findall(r"[\w']+", str(sent).lower())
        ids = [word_to_token[w] for w in words if w in word_to_token][:max_words]
        out[i, :len(ids)] = ids
    return out


class S3DGText(nn.Module):
    """The joint text-video embedding model.  ``forward(video, text_ids)``
    returns a dict with ``video_embedding`` and/or ``text_embedding``;
    ``encode_video`` takes clips (B, T, H, W, 3) (24 channels after the S2D
    reshuffle), fp32 (B, embd_dim) out."""

    def __init__(self, embd_dim: int = 512, space_to_depth: bool = True,
                 num_text_embeddings: int = 66250, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        kw = dict(dtype=dtype)
        self.space_to_depth = space_to_depth
        if space_to_depth:
            self.conv1 = STConv(24, 64, (2, 4, 4), 1, (1, 2, 2), **kw)
        else:
            self.conv1 = STConv(3, 64, (3, 7, 7), 2, (1, 3, 3), **kw)
        self.conv_2b = STConv(64, 64, 1, **kw)
        self.conv_2c = STConv(64, 192, 3, padding=1, separable=True, **kw)
        self.gating = SelfGating(192)
        cin = 192
        for name in MIXED:
            setattr(self, name, TextInceptionBlock(cin, *MIXED_SPECS[name], **kw))
            cin = TextInceptionBlock.out_channels(*MIXED_SPECS[name])
        self.fc = nn.Linear(cin, embd_dim)
        self.text_module = SentenceEmbedding(embd_dim, num_text_embeddings)
        self.dtype = dtype

    def encode_video(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.space_to_depth:
            x = self.conv1(to_ncdhw(space_to_depth_3d(x)))
            # the reference's SAME-padding correction (JAX s3dg_text.py:203)
            x = x[:, :, 1:, 1:, 1:]
        else:
            x = self.conv1(to_ncdhw(x))
        x = self._pool("conv1", x)
        x = self.gating(self.conv_2c(self.conv_2b(x)))
        x = self._pool("conv_2c", x)
        for name in MIXED:
            x = self._pool(name, getattr(self, name)(x))
        return self.fc(x.float().mean(dim=(2, 3, 4)))

    @staticmethod
    def _pool(after: str, x: torch.Tensor) -> torch.Tensor:
        if after not in STAGE_POOLS:
            return x
        return max_pool_3d(x, *STAGE_POOLS[after], "SAME")

    def forward(self, video: Optional[torch.Tensor] = None,
                text_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        out = {}
        if video is not None:
            out["video_embedding"] = self.encode_video(video)
        if text_ids is not None:
            out["text_embedding"] = self.text_module(text_ids)
        return out


def milnce_names(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A MIL-NCE state dict as :class:`S3DGText` loads it: a DDP ``module.``
    prefix and torch BN's ``num_batches_tracked`` counters dropped (the
    port's BN keeps flax's fixed momentum)."""
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return {k: v for k, v in sd.items() if not k.endswith(".num_batches_tracked")}


def reference_s3dg_text_shape_manifest(embd_dim: int = 512, space_to_depth: bool = True,
                                       num_embeddings: int = 66250) -> Dict[str, tuple]:
    """Name -> shape of a MIL-NCE state dict (the port's copy of JAX
    ``utils/torch_interop.py:reference_s3dg_text_shape_manifest``)."""
    manifest: Dict[str, tuple] = {}

    def stconv(base, cin, cout, k, separable):
        if separable:
            manifest[base + ".conv1.weight"] = (cout, cin, 1, k, k)
            manifest[base + ".conv2.weight"] = (cout, cout, k, 1, 1)
            bns = ("bn1", "bn2")
        else:
            manifest[base + ".conv1.weight"] = (cout, cin) + _triple(k)
            bns = ("bn1",)
        for bn in bns:
            for suffix in ("weight", "bias", "running_mean", "running_var"):
                manifest[f"{base}.{bn}.{suffix}"] = (cout,)

    def gating(base, c):
        manifest[base + ".fc.weight"] = (c, c)
        manifest[base + ".fc.bias"] = (c,)

    if space_to_depth:
        stconv("conv1", 24, 64, (2, 4, 4), False)
    else:
        stconv("conv1", 3, 64, (3, 7, 7), False)
    stconv("conv_2b", 64, 64, (1, 1, 1), False)
    stconv("conv_2c", 64, 192, 3, True)
    gating("gating", 192)
    in_ch = 192
    for blk in MIXED:
        b0, (b1r, b1), (b2r, b2), b3 = MIXED_SPECS[blk]
        stconv(f"{blk}.conv_b0", in_ch, b0, (1, 1, 1), False)
        stconv(f"{blk}.conv_b1_a", in_ch, b1r, (1, 1, 1), False)
        stconv(f"{blk}.conv_b1_b", b1r, b1, 3, True)
        stconv(f"{blk}.conv_b2_a", in_ch, b2r, (1, 1, 1), False)
        stconv(f"{blk}.conv_b2_b", b2r, b2, 3, True)
        stconv(f"{blk}.conv_b3_b", in_ch, b3, (1, 1, 1), False)
        for g, c in (("gating_b0", b0), ("gating_b1", b1), ("gating_b2", b2),
                     ("gating_b3", b3)):
            gating(f"{blk}.{g}", c)
        in_ch = b0 + b1 + b2 + b3
    manifest["fc.weight"] = (embd_dim, 1024)
    manifest["fc.bias"] = (embd_dim,)
    manifest["text_module.word_embd.weight"] = (num_embeddings, 300)
    manifest["text_module.fc1.weight"] = (2048, 300)
    manifest["text_module.fc1.bias"] = (2048,)
    manifest["text_module.fc2.weight"] = (embd_dim, 2048)
    manifest["text_module.fc2.bias"] = (embd_dim,)
    return manifest
