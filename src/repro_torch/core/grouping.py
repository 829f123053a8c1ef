"""Group-based aggregation support (§IV-D3): k-means over client
pseudo-label class distributions. Port of ``repro/core/grouping.py:31-99``,
the float64 host reference (numpy, as there); the device twin waits for
the sharded engine.

The server cannot see true client label distributions, so clients report
the class histogram of their own pseudo-labels.
"""
from __future__ import annotations

import numpy as np


def init_index(num_points: int, seed: int = 0) -> int:
    """First k-means center: the reference path's rng.integers draw."""
    return int(np.random.default_rng(seed).integers(num_points))


def kmeans(points, k, *, iters=20, seed=0):
    """points: (M, D) -> (assignments (M,), centers (k, D)). Deterministic
    k-means++-ish init (greedy farthest point)."""
    points = np.asarray(points, dtype=np.float64)
    M = points.shape[0]
    k = min(k, M)
    centers = [points[init_index(M, seed)]]
    for _ in range(1, k):
        d2 = np.min(
            [np.sum((points - c) ** 2, axis=1) for c in centers], axis=0)
        centers.append(points[int(np.argmax(d2))])
    centers = np.stack(centers)
    for _ in range(iters):
        d2 = ((points[:, None] - centers[None]) ** 2).sum(-1)
        assign = d2.argmin(1)
        for j in range(k):
            sel = points[assign == j]
            if len(sel):
                centers[j] = sel.mean(0)
    return assign, centers


def group_clients(histograms, num_groups, *, seed=0):
    """histograms: (M, C) pseudo-label distributions -> group index per client."""
    assign, _ = kmeans(histograms, num_groups, seed=seed)
    return assign
