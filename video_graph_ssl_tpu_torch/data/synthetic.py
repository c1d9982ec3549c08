"""Synthetic clip sources (copies of the numpy-only
``video_graph_ssl_tpu/data/synthetic.py``), no disk, no decode:

* ``SyntheticContrastiveDataset`` and ``SyntheticFrameDataset``:
  deterministic uint8 clips that go through
  :class:`~video_graph_ssl_tpu_torch.data.pipeline.Loader` like any dataset
  (``data/build.py``);
* ``temporal_motion_clips`` and ``temporal_shortcut_clips``: the float32
  probe sets of the graph-benefit A/B (``graph_benefit.py``), drawn from
  ``np.random.default_rng(seed)`` in the JAX package's call order, so the
  clips are bit-equal to its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class SyntheticContrastiveDataset:
    n_data: int = 256
    video_length: int = 16
    canvas_hw: Tuple[int, int] = (128, 128)
    num_classes: int = 101
    two_views: bool = True
    seed: int = 0

    def __len__(self) -> int:
        return self.n_data

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None):
        g = np.random.default_rng(self.seed * 1_000_003 + index)
        v = 2 if self.two_views else 1
        clips = g.integers(
            0, 256,
            (v, self.video_length, *self.canvas_hw, 3), dtype=np.uint8)
        label = np.int32(index % self.num_classes)
        return {"clips": clips, "label": label, "index": np.int32(index)}


# (dy, dx) px/frame — ± pairs along each axis so the order-free frame
# statistics of opposite classes are identical (see temporal_motion_clips).
MOTION_VELS = ((0, 1), (0, -1), (1, 0), (-1, 0))


def temporal_motion_clips(
    per_class: int = 12,
    t: int = 8,
    hw: Tuple[int, int] = (16, 16),
    seed: int = 0,
    noise: float = 0.5,
    n_classes: int = 4,
):
    """Clips whose class signal lives in frame ORDER, not appearance.

    Class ``c`` moves a soft periodic blob with velocity ``MOTION_VELS[c]``
    (wraparound).  Opposite-direction classes (+v / -v) traverse the same
    positions with random phase, so their time-POOLED frame statistics are
    identically distributed — only the temporal ordering separates them.
    Per-clip nuisance: random start position, per-view independent start +
    color mixing + pixel noise; the two views of a clip share ONLY the
    motion pattern.

    Role: the GCA **negative control** (``graph_benefit.py --dataset
    motion``).  When the class signal IS the frame order, the graph
    augmentation's stochastic temporal recomposition destroys the signal,
    and the graph arm is expected to lose retrieval.  The positive probe
    set is ``temporal_shortcut_clips``.

    Returns ``(clips, labels)``: (N, 2, T, H, W, 3) float32, (N,) int.
    """
    h, w = hw
    g = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    steps = np.arange(t)

    def blob_view(vy, vx):
        y0, x0 = g.integers(0, h), g.integers(0, w)
        cy = (y0 + vy * steps) % h          # (T,)
        cx = (x0 + vx * steps) % w
        # ring distance -> soft blob, periodic so wraparound is seamless
        dy = np.minimum(np.abs(yy[None] - cy[:, None, None]),
                        h - np.abs(yy[None] - cy[:, None, None]))
        dx = np.minimum(np.abs(xx[None] - cx[:, None, None]),
                        w - np.abs(xx[None] - cx[:, None, None]))
        bump = np.exp(-(dy ** 2 + dx ** 2) / (2 * 1.5 ** 2))  # (T, H, W)
        color = g.uniform(0.5, 1.5, 3)
        frames = bump[..., None] * color * 3.0
        frames += g.normal(0.0, noise, frames.shape)
        return frames.astype(np.float32)

    clips, labels = [], []
    for c in range(n_classes):
        vy, vx = MOTION_VELS[c % len(MOTION_VELS)]
        for _ in range(per_class):
            clips.append(np.stack([blob_view(vy, vx), blob_view(vy, vx)]))
            labels.append(c)
    return np.stack(clips), np.asarray(labels)


def temporal_shortcut_clips(
    per_class: int = 12,
    t: int = 8,
    hw: Tuple[int, int] = (16, 16),
    seed: int = 0,
    noise: float = 0.5,
    n_classes: int = 4,
    k_protos: int = 4,
):
    """Clips where temporal ORDER is an instance shortcut and CONTENT is
    the class signal — the probe set for the GCA mechanism.

    Class ``c`` owns ``k_protos`` prototype frame patterns.  A clip is a
    per-clip random arrangement of its class's prototypes over T frames;
    the clip's two views share that arrangement (plus independent pixel
    noise and color gain).  Consequences for contrastive pretraining:

      * same-class clips share CONTENT (the prototype set) and differ only
        in ARRANGEMENT — so InfoNCE can separate these hard negatives only
        through temporal-order features;
      * class retrieval over encoder features rewards CONTENT.

    A plain encoder is therefore pushed toward order features (hurting
    class retrieval), while the graph-composed augmentation
    (TemporalGraphAug) stochastically recomposes temporal relations,
    making the order shortcut unreliable and steering features toward
    content — the reference paper's claim (README.md:48-58) in
    synthetic, executable form.

    Returns ``(clips, labels)``: (N, 2, T, H, W, 3) float32, (N,) int.
    """
    h, w = hw
    g = np.random.default_rng(seed)
    yy = np.linspace(0, 2 * np.pi, h, endpoint=False)
    xx = np.linspace(0, 2 * np.pi, w, endpoint=False)

    # smooth, well-separated prototypes: random low-frequency sinusoid mixes
    def proto():
        img = np.zeros((h, w, 3))
        for _ in range(3):
            fy, fx = g.integers(1, 4, 2)
            phase = g.uniform(0, 2 * np.pi, 2)
            amp = g.uniform(0.8, 1.6, 3)
            img += (np.sin(fy * yy[:, None] + phase[0])
                    * np.sin(fx * xx[None, :] + phase[1]))[..., None] * amp
        return img

    protos = np.stack([np.stack([proto() for _ in range(k_protos)])
                       for _ in range(n_classes)])  # (C, K, H, W, 3)

    clips, labels = [], []
    for c in range(n_classes):
        for _ in range(per_class):
            seq = g.integers(0, k_protos, t)          # the clip's arrangement
            views = []
            for _v in range(2):
                gain = g.uniform(0.7, 1.3, 3)
                frames = protos[c, seq] * gain
                frames = frames + g.normal(0.0, noise, frames.shape)
                views.append(frames.astype(np.float32))
            clips.append(np.stack(views))
            labels.append(c)
    return np.stack(clips), np.asarray(labels)


@dataclass
class SyntheticFrameDataset:
    n_data: int = 256
    video_length: int = 16
    canvas_hw: Tuple[int, int] = (128, 128)
    num_classes: int = 101
    test_mode: bool = False
    num_clips: int = 10
    seed: int = 0

    def __len__(self) -> int:
        return self.n_data

    def __getitem__(self, index: int,
                    rng: Optional[np.random.Generator] = None):
        g = np.random.default_rng(self.seed * 1_000_003 + index)
        if self.test_mode and self.num_clips > 0:
            shape = (self.num_clips, self.video_length, *self.canvas_hw, 3)
        else:
            shape = (self.video_length, *self.canvas_hw, 3)
        clips = g.integers(0, 256, shape, dtype=np.uint8)
        label = np.int32(index % self.num_classes)
        return {"clips": clips, "label": label, "index": np.int32(index)}
