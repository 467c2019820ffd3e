"""Hypothesis verification masks and top-M + IoU-NMS candidate selection
(counterpart of ``multih_tpu/models/selection.py``)."""

from __future__ import annotations

import torch


def top_k_stable(x: torch.Tensor, k: int):
    """`jax.lax.top_k` over the last axis: values descending, and among
    equal values the lower index first. Counts are small integers, so
    ties are everywhere; torch.topk promises no tie order (on CUDA least
    of all), a stable descending sort does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
):
    """Top-M by inlier count, then greedy IoU-NMS down to K candidates.

    Returns (cand_idx (K,) into the hypothesis pool, cand_active (K,)
    float): which slots hold a real (non-suppressed, non-empty)
    candidate. The K greedy rounds stay tensor ops: nothing waits on the
    device inside the loop."""
    masks = inlier_mask(residuals, threshold_sq, valid)  # (S, N)
    counts = masks.sum(1) * hypothesis_ok
    top_counts, top_idx = top_k_stable(counts, n_candidates)
    top_masks = masks[top_idx]
    inter = top_masks @ top_masks.T  # exact: integer sums < 2^24
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
