"""Metrics: AverageMeter, top-k accuracy, mAP (a copy of
``video_graph_ssl_tpu/utils/meters.py``).

Counterpart of lib/evaluation/metric.py (AverageMeter :9-24, accuracy
:44-67, map/MAPMetric :26-42,69-93).  numpy-based host-side versions; the
on-device top-k of the step lives in ``engine.pretrain.topk_accuracy``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class AverageMeter:
    """Running value/average/sum/count (reference: metric.py:9-24)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def accuracy(output: np.ndarray, target: np.ndarray,
             topk: Sequence[int] = (1,)) -> Tuple[float, ...]:
    """Top-k accuracy in percent (reference: metric.py:44-67).

    ``target`` may be:
      * ``(N,)`` int labels — standard top-k accuracy;
      * ``(N, C)`` multi-label — counts every top-k prediction that hits a
        positive class (>0.5), matching the reference's element loop
        (metric.py:57-61) which sums all hits, not any-hit per sample;
      * ``(N, T, C)`` — max-pooled over the middle axis first
        (metric.py:46-47).
    """
    output = np.asarray(output)
    target = np.asarray(target)
    if target.ndim == 3:
        target = target.max(axis=1)
    maxk = max(topk)
    n = target.shape[0]
    pred = np.argsort(-output, axis=1)[:, :maxk]  # (N, maxk)
    if target.ndim == 1:
        correct = pred == target[:, None]
        # single-label: at most one hit per row, so sum == any
        return tuple(float(correct[:, :k].sum() * 100.0 / n) for k in topk)
    # multi-label: correct[i, j] = target[i, pred[i, j]] > 0.5
    correct = np.take_along_axis(target, pred, axis=1) > 0.5
    return tuple(float(correct[:, :k].sum() * 100.0 / n) for k in topk)


def average_precision(output: np.ndarray, target: np.ndarray) -> float:
    """AP for one class: mean precision at each positive hit
    (reference: map, metric.py:26-42)."""
    order = np.argsort(-output)
    target = target[order]
    hits = np.cumsum(target)
    ranks = np.arange(1, len(target) + 1)
    prec = hits / ranks
    pos = target > 0
    if pos.sum() == 0:
        return 0.0
    return float((prec * pos).sum() / pos.sum())


def mean_average_precision(output: np.ndarray, target: np.ndarray) -> float:
    """mAP over classes; target is one-hot / multi-label (N, C)
    (reference: MAPMetric, metric.py:69-93)."""
    aps = [average_precision(output[:, c], target[:, c])
           for c in range(output.shape[1])]
    return float(np.mean(aps))
