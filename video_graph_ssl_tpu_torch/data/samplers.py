"""Frame-index samplers — exact ports of the reference's index math (a copy
of ``video_graph_ssl_tpu/data/samplers.py``; the same draws from the same
``Generator``).

Retrieval / fine-tune parity depends on identical frame selection
(SURVEY.md §7 hard-part (a)), so these reproduce the arithmetic of
``BaseDataset`` (lib/data/datasets/dataset.py:71-161) and ``VisualDataset``
(lib/data/datasets/video_contrast_dataset.py:82-149) exactly, including the
two classes' differing uniform-sampler offsets (``num_frames-new_length+1``
vs ``num_frames+1``).

All samplers return 1-based frame indices (the reference's ``offsets + 1``),
and take an explicit ``np.random.Generator`` for deterministic pipelines.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _rng(rng: Optional[np.random.Generator]) -> np.random.Generator:
    return rng if rng is not None else np.random.default_rng()


def sample_indices_uniform(
    num_frames: int, video_length: int, new_length: int = 1,
    rng: Optional[np.random.Generator] = None, contrast: bool = False,
) -> np.ndarray:
    """Random uniform-segment sampling.

    ``contrast=False``: BaseDataset._sample_indices (dataset.py:71-85);
    ``contrast=True``: VisualDataset._sample_indices
    (video_contrast_dataset.py:82-96), which uses ``num_frames + 1``.
    """
    rng = _rng(rng)
    span = (num_frames + 1) if contrast else (num_frames - new_length + 1)
    average_duration = span // video_length
    if average_duration > 0:
        offsets = (np.arange(video_length) * average_duration
                   + rng.integers(0, average_duration, size=video_length))
    elif num_frames > video_length:
        offsets = np.sort(rng.integers(0, span, size=video_length))
    else:
        offsets = np.zeros(video_length, dtype=np.int64)
    return offsets.astype(np.int64) + 1


def val_indices(
    num_frames: int, video_length: int, new_length: int = 1,
    contrast: bool = False,
) -> np.ndarray:
    """Deterministic center sampling (dataset.py:87-93 /
    video_contrast_dataset.py:98-104)."""
    span_ok = (num_frames > video_length - 1) if contrast else (
        num_frames > video_length + new_length - 1)
    if span_ok:
        tick = ((num_frames + 1) if contrast
                else (num_frames - new_length + 1)) / float(video_length)
        offsets = np.array([int(tick / 2.0 + tick * x)
                            for x in range(video_length)])
    else:
        offsets = np.zeros(video_length, dtype=np.int64)
    return offsets.astype(np.int64) + 1


def dense_indices(
    num_frames: int, video_length: int, step: int = 4,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Dense stride-``step`` sampling with shrinking fallbacks
    (dataset.py:95-111, identical in video_contrast_dataset.py:106-123)."""
    rng = _rng(rng)
    expanded = video_length * step
    if num_frames >= expanded:
        start = int(rng.integers(0, num_frames - expanded + 1))
        offsets = np.arange(start, start + expanded, step)
    elif num_frames > video_length * (step // 2):
        span = video_length * (step // 2)
        start = int(rng.integers(0, num_frames - span + 1))
        offsets = np.arange(start, start + span, step // 2)
    elif num_frames > video_length:
        start = int(rng.integers(0, num_frames - video_length + 1))
        offsets = np.arange(start, start + video_length)
    else:
        offsets = np.sort(rng.integers(0, num_frames, size=video_length))
    return offsets.astype(np.int64) + 1


def adver_indices(
    num_frames: int, video_length: int, nsamples: int,
    new_length: int = 1, rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """``nsamples`` independent uniform-segment draws, concatenated
    (dataset.py:113-135)."""
    rng = _rng(rng)
    average_duration = (num_frames - new_length + 1) // video_length
    out = []
    if average_duration > 0:
        start = np.arange(video_length) * average_duration
        for _ in range(nsamples):
            out.extend(start + rng.integers(0, average_duration,
                                            size=video_length) + 1)
    elif num_frames > video_length:
        for _ in range(nsamples):
            out.extend(rng.integers(0, num_frames - new_length + 1,
                                    size=video_length) + 1)
    else:
        for _ in range(nsamples):
            out.extend(np.ones(video_length, dtype=np.int64))
    return np.asarray(out, dtype=np.int64)


def test_indices(
    num_frames: int, video_length: int, new_length: int = 1,
    contrast: bool = False,
) -> np.ndarray:
    """Deterministic center sampling for test mode (dataset.py:137-143)."""
    tick = ((num_frames + 1) if contrast
            else (num_frames - new_length + 1)) / float(video_length)
    offsets = np.array([int(tick / 2.0 + tick * x)
                        for x in range(video_length)])
    return offsets.astype(np.int64) + 1


def nclips_test_indices(
    num_frames: int, video_length: int, num_clips: int = 10, step: int = 4,
) -> np.ndarray:
    """N temporally-spread dense clips for video-level testing
    (dataset.py:145-161): clip starts spread across the video, each clip
    stride-``step``, indices clamped to [1, num_frames-1]."""
    tick = (num_frames - video_length * step + 1) / float(num_clips)
    starts = np.array([int(tick / 2.0 + tick * x) for x in range(num_clips)])
    offsets = []
    for p in starts:
        offsets.extend(range(p, p + video_length * step, step))
    checked = np.asarray(offsets, dtype=np.int64) + 1
    checked = np.clip(checked, 1, max(num_frames - 1, 1))
    return checked
