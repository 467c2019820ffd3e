"""`jax.lax.top_k`'s order in PyTorch, shared by the sampling, labeling
and selection stages."""

from __future__ import annotations

import torch


def top_k_stable(x: torch.Tensor, k: int):
    """`jax.lax.top_k` over the last axis: values descending, and among
    equal values the lower index first. Counts are small integers, so
    ties are everywhere; torch.topk promises no tie order (on CUDA least
    of all), a stable descending sort does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
