"""Pre-resized binary frame shards — the production ingest path (a copy of
``video_graph_ssl_tpu/data/shards.py``, the same file layout: a store
written by either package is read by the other).

Decode and canvas-resize happen ONCE offline (``write_shard_store`` /
``python -m video_graph_ssl_tpu_torch.build_shards``); training then reads
raw uint8 frames from memory-mapped flat files, so clip assembly is a
fancy-index copy out of the page cache with no codec in the hot path.  All
augmentation stays on the device (``transforms_device.py``), so shards
store exactly the ``decode.load_clip`` canvas output.  A store needs no cv2
or PIL to read.

Layout of a store directory::

    shards.json            metadata + per-video locations
    shard_00000.bin        concatenated (num_frames, H, W, C) uint8 blocks

``ShardStore.load_clip`` mirrors decode.load_clip's semantics (1-based
indices, ``new_length`` consecutive frames stacked on channels with
saturation at num_frames — reference dataset.py:178-191) so datasets can
swap ``pre_load='shard'`` in with no behavioral change.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .decode import load_clip as _decode_load_clip
from .records import VideoRecord, parse_split

_META_NAME = "shards.json"
_SHARD_TMPL = "shard_{:05d}.bin"


def _frame_nbytes(canvas_hw: Tuple[int, int], channels: int) -> int:
    return int(canvas_hw[0]) * int(canvas_hw[1]) * int(channels)


def write_shard_store(
    root_path: str,
    list_files: Sequence[str],
    out_dir: str,
    canvas_hw: Tuple[int, int],
    image_tmpl: str = "img_{:05d}.jpg",
    modality: str = "RGB",
    pre_load: str = "cv2",
    shard_bytes: int = 512 << 20,
    frame_source=None,
) -> dict:
    """Build a shard store from frame folders.

    Every unique video across ``list_files`` is decoded frame by frame
    (``frame_source(directory, frame_idx_1based) -> (H,W,C) uint8``
    overrides the JPEG loader — used by tests/benches to synthesize
    stores), resized to ``canvas_hw``, and appended to rolling shard
    files capped at ``shard_bytes``.
    """
    os.makedirs(out_dir, exist_ok=True)
    channels = 2 if modality == "Flow" else 3
    fb = _frame_nbytes(canvas_hw, channels)

    # unique videos, first-seen order
    seen: Dict[str, VideoRecord] = {}
    for lf in list_files:
        for rec in parse_split(lf):
            seen.setdefault(rec.path, rec)

    videos: Dict[str, list] = {}
    shard_idx, shard_off = 0, 0
    fh = open(os.path.join(out_dir, _SHARD_TMPL.format(shard_idx)), "wb")
    try:
        for rec in seen.values():
            nbytes = rec.num_frames * fb
            if shard_off and shard_off + nbytes > shard_bytes:
                fh.close()
                shard_idx += 1
                shard_off = 0
                fh = open(os.path.join(out_dir, _SHARD_TMPL.format(shard_idx)),
                          "wb")
            directory = os.path.join(root_path, rec.path)
            for fi in range(1, rec.num_frames + 1):
                if frame_source is not None:
                    frame = np.ascontiguousarray(
                        frame_source(directory, fi), dtype=np.uint8)
                    assert frame.shape == (*canvas_hw, channels), frame.shape
                else:
                    # one-frame clip via the canonical decoder keeps shard
                    # content bit-identical to the online path
                    frame = _decode_load_clip(
                        directory, image_tmpl, [fi], pre_load, canvas_hw,
                        modality, new_length=1,
                        num_frames=rec.num_frames)[0]
                fh.write(frame.tobytes())
            videos[rec.path] = [shard_idx, shard_off, rec.num_frames]
            shard_off += nbytes
    finally:
        fh.close()

    meta = {
        "version": 1,
        "canvas": [int(canvas_hw[0]), int(canvas_hw[1])],
        "channels": channels,
        "modality": modality,
        "num_shards": shard_idx + 1,
        "videos": videos,
    }
    with open(os.path.join(out_dir, _META_NAME), "w") as f:
        json.dump(meta, f)
    return meta


class ShardStore:
    """Memory-mapped reader over a shard store directory."""

    def __init__(self, store_dir: str):
        with open(os.path.join(store_dir, _META_NAME)) as f:
            self.meta = json.load(f)
        self.canvas_hw: Tuple[int, int] = tuple(self.meta["canvas"])
        self.channels: int = int(self.meta["channels"])
        self._videos: Dict[str, list] = self.meta["videos"]
        self._fb = _frame_nbytes(self.canvas_hw, self.channels)
        self._mms: List[np.memmap] = [
            np.memmap(os.path.join(store_dir, _SHARD_TMPL.format(k)),
                      dtype=np.uint8, mode="r")
            for k in range(int(self.meta["num_shards"]))
        ]

    def __contains__(self, video_path: str) -> bool:
        return video_path in self._videos

    def num_frames(self, video_path: str) -> int:
        return int(self._videos[video_path][2])

    def frames(self, video_path: str) -> np.ndarray:
        """Lazy (num_frames, H, W, C) uint8 view (no copy until indexed)."""
        shard, off, n = self._videos[video_path]
        h, w = self.canvas_hw
        return self._mms[shard][off:off + n * self._fb].reshape(
            n, h, w, self.channels)

    def load_clip(
        self,
        video_path: str,
        indices: Sequence[int],
        new_length: int = 1,
        num_frames: Optional[int] = None,
    ) -> np.ndarray:
        """(T, H, W, C·new_length) uint8 — decode.load_clip semantics."""
        view = self.frames(video_path)
        n = int(num_frames) if num_frames is not None else view.shape[0]
        nl = max(1, int(new_length))
        idx = np.asarray(indices, np.int64)[:, None] + np.arange(nl)[None, :]
        # saturation: ``if p < num_frames: p += 1`` (dataset.py:183-188)
        idx = np.minimum(idx, n)
        frames = view[idx - 1]  # (T, nl, H, W, C) copy of just these frames
        t, _, h, w, c = frames.shape
        return frames.transpose(0, 2, 3, 1, 4).reshape(t, h, w, nl * c)
