"""Judging one pair's labels against the scene's truth, and the model's
weighted refit in float64, shared by the plane and motion references."""

from __future__ import annotations

import numpy as np


def misclassification_pct(pred: np.ndarray, gt: np.ndarray,
                          pred_outlier: int) -> float:
    """Misclassification % of a labeling under the best one-to-one
    matching of predicted models to true ones (gt 0 = outlier, gt < 0 =
    padding, ignored): the share of points whose matched label differs.
    The matching is exact, by dynamic programming over the subsets of
    true models (a scene has a handful)."""
    keep = gt >= 0
    pred, gt = pred[keep], gt[keep]
    n = pred.size
    if n == 0:
        return 0.0
    p_ids = np.unique(pred[pred != pred_outlier])
    g_ids = np.unique(gt[gt != 0])
    conf = np.array([[np.sum((pred == p) & (gt == g)) for g in g_ids]
                     for p in p_ids], np.int64).reshape(p_ids.size,
                                                        g_ids.size)
    best = {0: 0}  # mask of true models used -> best matched count
    for i in range(p_ids.size):
        nxt = dict(best)
        for mask, v in best.items():
            for j in range(g_ids.size):
                if not mask >> j & 1:
                    m2, v2 = mask | 1 << j, v + conf[i, j]
                    if nxt.get(m2, -1) < v2:
                        nxt[m2] = v2
        best = nxt
    right = max(best.values()) + np.sum((pred == pred_outlier) & (gt == 0))
    return 100.0 * (1.0 - right / n)


def hartley(p: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The weighted Hartley similarity of points p (n, 2): the weighted
    centroid to the origin and the weighted RMS distance to sqrt(2)."""
    ws = w.sum()
    c = (w[:, None] * p).sum(0) / ws
    rms = np.sqrt(max((w * ((p - c) ** 2).sum(1)).sum() / ws, 1e-24))
    s = np.sqrt(2.0) / rms
    return np.array([[s, 0.0, -s * c[0]], [0.0, s, -s * c[1]],
                     [0.0, 0.0, 1.0]])


def homogeneous(p: np.ndarray) -> np.ndarray:
    return np.concatenate([p, np.ones((p.shape[0], 1))], axis=1)


def smallest_eigvec(a: np.ndarray) -> np.ndarray:
    """The unit eigenvector of a symmetric matrix's smallest eigenvalue."""
    return np.linalg.eigh(a)[1][:, 0]


def tukey(r: np.ndarray, thr: float) -> np.ndarray:
    """The fit's refit weights: (1 - r/thr)^2 inside the squared
    threshold, 0 outside."""
    return np.where(r < thr, (1.0 - np.clip(r / thr, 0.0, 1.0)) ** 2, 0.0)
