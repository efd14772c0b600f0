"""Keypoint metrics (host-side numpy): PCK / PCKh / AUC / EPE (a copy of
``litehandnet_tpu/eval/metrics.py``).

Matches reference utils/post_processing/evaluation/top_down_eval.py:12-196:
distances are bbox-normalized per axis; invisible joints and degenerate
normalizers are masked out; AUC sweeps PCK over 20 thresholds in [0, 1).
"""

from __future__ import annotations

import numpy as np


def _calc_distances(preds, targets, mask, normalize):
    """[N, K] normalized distances; -1 where masked (reference :12-41)."""
    N, K, _ = preds.shape
    _mask = mask.copy()
    _mask[np.where((normalize == 0).sum(1))[0], :] = False
    distances = np.full((N, K), -1, dtype=np.float32)
    normalize = normalize.copy().astype(np.float32)
    normalize[np.where(normalize <= 0)] = 1e6
    distances[_mask] = np.linalg.norm(
        ((preds - targets) / normalize[:, None, :])[_mask], axis=-1
    )
    return distances.T


def _distance_acc(distances, thr=0.5):
    valid = distances != -1
    n = valid.sum()
    if n > 0:
        return (distances[valid] < thr).sum() / n
    return -1


def keypoint_pck_accuracy(pred, gt, mask, thr, normalize):
    """Per-keypoint and average PCK (reference :65-101).

    Returns:
        (acc [K], avg_acc float, cnt int)
    """
    distances = _calc_distances(pred, gt, mask, normalize)
    acc = np.array([_distance_acc(d, thr) for d in distances])
    valid_acc = acc[acc >= 0]
    cnt = len(valid_acc)
    avg_acc = valid_acc.mean() if cnt > 0 else 0
    return acc, avg_acc, cnt


def keypoint_auc(pred, gt, mask, normalize, num_step=20):
    """PCK area-under-curve over `num_step` thresholds (reference :167-196)."""
    nor = np.tile(np.array([[normalize, normalize]]), (pred.shape[0], 1))
    y = []
    for i in range(num_step):
        thr = 1.0 * i / num_step
        _, avg_acc, _ = keypoint_pck_accuracy(pred, gt, mask, thr, nor)
        y.append(avg_acc)
    return sum(y) / num_step


def keypoint_epe(pred, gt, mask):
    """Average end-point error in pixels (reference :104-126)."""
    distances = _calc_distances(
        pred, gt, mask, np.ones((pred.shape[0], pred.shape[2]), np.float32)
    )
    valid = distances[distances != -1]
    return valid.sum() / max(1, len(valid))
