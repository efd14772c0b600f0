"""k-means hand-size clustering for size-stratified eval splits (port of
``litehandnet_tpu/utils/kmeans.py``, host numpy).

Reference: utils/k_means.py:7-75 — 2-cluster split of bbox max-side sizes
used to build small/middle/large FreiHAND test subsets
(split_testset/freihand_20/*.json).
"""

from __future__ import annotations

import numpy as np


def kmeans_1d(values: np.ndarray, k: int = 2, iters: int = 100, seed: int = 0):
    """1-D k-means. Returns (centers [k], labels [N])."""
    values = np.asarray(values, np.float64).reshape(-1)
    rng = np.random.RandomState(seed)
    centers = np.sort(rng.choice(values, size=k, replace=False))
    labels = np.zeros(len(values), np.int64)
    for _ in range(iters):
        dists = np.abs(values[:, None] - centers[None, :])
        new_labels = dists.argmin(axis=1)
        if (new_labels == labels).all():
            break
        labels = new_labels
        for j in range(k):
            sel = values[labels == j]
            if len(sel):
                centers[j] = sel.mean()
    order = np.argsort(centers)
    remap = np.empty_like(order)
    remap[order] = np.arange(k)
    return centers[order], remap[labels]


def split_by_size(db, k: int = 2):
    """Cluster dataset records by bbox max-side; returns index lists per
    cluster (smallest first), the reference's small/large analysis."""
    sizes = np.array([max(rec["bbox"][2], rec["bbox"][3]) for rec in db])
    _, labels = kmeans_1d(sizes, k=k)
    return [np.where(labels == j)[0].tolist() for j in range(k)]


def kmeans_ref(relative_sizes, centers=(0.2, 0.4, 0.6, 0.8),
               max_iters: int = 10_000):
    """The reference's exact 1-D k-means over relative bbox areas
    (utils/k_means.py:7-28), quirks kept: per-cluster counts initialize
    to ONE (sum to zero), so empty clusters decay toward 0 and every
    mean is biased by one phantom zero sample; convergence tests the SUM
    of centers for exact equality.

    ``max_iters`` is a termination backstop absent upstream: the exact
    sum-equality test can oscillate forever between assignments with
    equal center sums; real-data runs converge in a handful of steps.

    Returns (centers [k], counts [k]).
    """
    sizes = np.asarray(relative_sizes, np.float64).reshape(-1)
    centers = np.asarray(centers, np.float64).copy()
    k = len(centers)
    count = np.ones(k)
    for _ in range(max_iters):
        sum_sizes = np.zeros(k)
        count = np.ones(k)
        idx = np.abs(centers[None, :] - sizes[:, None]).argmin(axis=1)
        np.add.at(sum_sizes, idx, sizes)
        np.add.at(count, idx, 1.0)
        centers_new = sum_sizes / count
        if centers_new.sum() - centers.sum() == 0:
            return centers_new, count
        centers = centers_new
    return centers, count


def size_thresholds(relative_sizes, cluster_centers):
    """Midpoint thresholds between adjacent cluster centers + per-bin
    counts (reference utils/k_means.py:31-46). Returns
    (thresholds [k-1], counts [k])."""
    centers = np.asarray(cluster_centers, np.float64)
    rs = np.asarray(relative_sizes, np.float64).reshape(-1)
    if len(centers) < 2:  # one cluster: no thresholds, one bin
        return [], [int(rs.size)]
    thresholds = [
        float((centers[i + 1] + centers[i]) / 2)
        for i in range(len(centers) - 1)
    ]
    counts = [int((rs < thresholds[0]).sum())]
    for i in range(1, len(thresholds)):
        counts.append(int(((rs >= thresholds[i - 1])
                           & (rs < thresholds[i])).sum()))
    counts.append(int((rs >= thresholds[-1]).sum()))
    return thresholds, counts
