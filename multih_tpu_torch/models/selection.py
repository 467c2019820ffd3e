"""Hypothesis verification masks and candidate selection: top-M +
IoU-NMS for homographies, greedy marginal coverage for fundamental
matrices (counterpart of ``multih_tpu/models/selection.py``)."""

from __future__ import annotations

import torch

from multih_tpu_torch.ops.topk import top_k_stable


def inlier_mask(residuals, threshold_sq, valid):
    """(S, N) squared residuals -> (S, N) float {0,1} inlier mask, zeroed
    on padded points."""
    return (residuals < threshold_sq).to(residuals.dtype) * valid[None, :]


def select_candidates(
    residuals: torch.Tensor,
    valid: torch.Tensor,
    threshold_sq: torch.Tensor,
    hypothesis_ok: torch.Tensor,
    n_candidates: int,
    max_labels: int,
    nms_iou: float,
    reduce=None,
):
    """Top-M by inlier count, then greedy IoU-NMS down to K candidates.

    Returns (cand_idx (K,) into the hypothesis pool, cand_active (K,)
    float): which slots hold a real (non-suppressed, non-empty)
    candidate. The K greedy rounds stay tensor ops: nothing waits on the
    device inside the loop. `reduce` sums the counts and intersections
    over a 'pt' mesh's ranks, each holding its points' residuals."""
    if reduce is None:
        def reduce(t):
            return t
    masks = inlier_mask(residuals, threshold_sq, valid)  # (S, N)
    counts = reduce(masks.sum(1)) * hypothesis_ok
    top_counts, top_idx = top_k_stable(counts, n_candidates)
    top_masks = masks[top_idx]
    inter = reduce(top_masks @ top_masks.T)  # exact: integer sums < 2^24
    union = top_counts[:, None] + top_counts[None, :] - inter
    iou = inter / torch.clamp_min(union, 1.0)

    m = top_counts.shape[0]
    dev = residuals.device
    ids = torch.arange(m, device=dev)
    alive = torch.ones(m, dtype=residuals.dtype, device=dev)
    picked = torch.zeros(max_labels, dtype=torch.int64, device=dev)
    picked_ok = torch.zeros(max_labels, dtype=torch.float32, device=dev)
    for k in range(max_labels):
        score = top_counts * alive
        best = torch.argmax(score).view(1)
        ok = score[best] > 0.0  # (1,)
        picked[k:k + 1] = best
        picked_ok[k:k + 1] = ok.float()
        suppress = (iou[best][0] >= nms_iou) | (ids == best)
        alive = torch.where(ok, alive * (1.0 - suppress.to(alive.dtype)),
                            alive)
    return top_idx[picked], picked_ok


def select_candidates_coverage(
    residuals: torch.Tensor,
    valid: torch.Tensor,
    threshold_sq: torch.Tensor,
    hypothesis_ok: torch.Tensor,
    n_candidates: int,
    max_labels: int,
    min_gain: float = 4.0,
    reduce=None,
):
    """Greedy marginal-coverage selection of K candidates among the top-M
    by count: each round picks the hypothesis covering the most
    still-uncovered points (first on ties) and marks its inliers covered;
    a slot whose best gain is below `min_gain` points is inactive.

    The fundamental model's rule (selection.py:98-153): one F often
    bridges two motions and outcounts every pure model, so count + NMS
    would fill the roster with bridges; once a bridge is taken its points
    stop counting. Returns (cand_idx (K,), cand_active (K,) float).
    `reduce` sums the counts and each round's gains over a 'pt' mesh's
    ranks, each holding its points' residuals."""
    if reduce is None:
        def reduce(t):
            return t
    masks = inlier_mask(residuals, threshold_sq, valid)  # (S, N)
    counts = reduce(masks.sum(1)) * hypothesis_ok
    top_counts, top_idx = top_k_stable(counts, n_candidates)
    top_masks = masks[top_idx] * (top_counts > 0).to(masks.dtype)[:, None]

    dev = residuals.device
    uncovered = valid.to(residuals.dtype)
    picked = torch.zeros(max_labels, dtype=torch.int64, device=dev)
    picked_ok = torch.zeros(max_labels, dtype=torch.float32, device=dev)
    for k in range(max_labels):
        gain = reduce(top_masks @ uncovered)  # exact: integer sums < 2^24
        best = torch.argmax(gain).view(1)
        ok = gain[best] >= min_gain  # (1,)
        picked[k:k + 1] = best
        picked_ok[k:k + 1] = ok.float()
        uncovered = torch.where(ok, uncovered * (1.0 - top_masks[best][0]),
                                uncovered)
    return top_idx[picked], picked_ok
