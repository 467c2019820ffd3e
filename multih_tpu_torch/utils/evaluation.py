"""Misclassification error vs ground truth (numpy + scipy): a copy of
``multih_tpu.utils.evaluation`` that imports without JAX."""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def _confusion(pred, gt, pred_outlier, gt_outlier):
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    keep = gt >= 0
    pred, gt = pred[keep], gt[keep]
    pred_ids = np.unique(pred[pred != pred_outlier])
    gt_ids = np.unique(gt[gt != gt_outlier])
    conf = np.zeros((pred_ids.size, gt_ids.size), np.int64)
    for i, p in enumerate(pred_ids):
        for j, g in enumerate(gt_ids):
            conf[i, j] = np.sum((pred == p) & (gt == g))
    return pred, gt, pred_ids, gt_ids, conf


def misclassification_error(
    pred: np.ndarray,
    gt: np.ndarray,
    pred_outlier: int,
    gt_outlier: int = 0,
) -> float:
    """Misclassification % under optimal (Hungarian) plane-label matching;
    gt entries < 0 are padding and ignored."""
    pred, gt, _, _, conf = _confusion(pred, gt, pred_outlier, gt_outlier)
    n = pred.size
    if n == 0:
        return 0.0
    correct = np.sum((pred == pred_outlier) & (gt == gt_outlier))
    if conf.size:
        ri, ci = linear_sum_assignment(-conf)
        correct += conf[ri, ci].sum()
    return 100.0 * (1.0 - correct / n)


def match_labels(
    pred: np.ndarray, gt: np.ndarray, pred_outlier: int, gt_outlier: int = 0
) -> dict:
    """The optimal pred-plane -> gt-plane mapping used by the metric."""
    _, _, pred_ids, gt_ids, conf = _confusion(pred, gt, pred_outlier,
                                              gt_outlier)
    mapping = {int(pred_outlier): int(gt_outlier)}
    if conf.size:
        ri, ci = linear_sum_assignment(-conf)
        for i, j in zip(ri, ci):
            mapping[int(pred_ids[i])] = int(gt_ids[j])
    return mapping
