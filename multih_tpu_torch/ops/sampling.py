"""Minimal-sample index draws for hypothesis generation (PyTorch).

Counterpart of ``multih_tpu/ops/sampling.py``. The JAX package draws with
threefry counter keys; PyTorch cannot reproduce those bits, so every
random number enters through a small *draw source* object with three
methods. `TorchDraws` is the default: one ``torch.Generator`` on the
fit's device. The parity tests pass a source that replays the JAX fit's
own threefry draws, so both packages sample the same indices.

A draw source takes a `stream` argument first: an opaque tag of the
call site (the progressive round), which a replaying source maps to the
JAX key of that call and `TorchDraws` ignores.
"""

from __future__ import annotations

import torch

MINIMAL_SAMPLE = 4


class TorchDraws:
    """Default draw source over an explicit ``torch.Generator``.

    Uniforms are drawn on the generator's device and moved to the fit's.
    A CUDA generator draws other bits than a CPU one of the same seed, so
    a CPU generator is the way to give a CPU fit and a card fit the same
    samples, as one ``jax.random.key`` gives every platform the same.

    `jax.random.randint` takes a traced maxval (sampling.py:38, :118);
    here uniforms are drawn and scaled by `n_valid` as tensors, so no
    draw waits on the device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _uniform(self, shape, device):
        return torch.rand(shape, generator=self.generator,
                          device=self.generator.device).to(device)

    def ranks(self, stream, n_samples: int, n_valid: torch.Tensor,
              m: int) -> torch.Tensor:
        """(S, m) raw draws r_j uniform in [0, max(n_valid - j, 1))."""
        dev = n_valid.device
        hi = torch.clamp_min(
            n_valid - torch.arange(m, device=dev), 1
        )  # (m,)
        r = torch.floor(self._uniform((n_samples, m), dev) * hi).long()
        return torch.minimum(r, hi - 1)

    def seed_ranks(self, stream, n_samples: int,
                   n_valid: torch.Tensor) -> torch.Tensor:
        """(S,) seed ranks uniform in [0, max(n_valid, 1))."""
        hi = torch.clamp_min(n_valid, 1)
        r = torch.floor(self._uniform((n_samples,), n_valid.device)
                        * hi).long()
        return torch.minimum(r, hi - 1)

    def gumbel(self, stream, n_samples: int, k: int,
               device: torch.device) -> torch.Tensor:
        """(S, k) standard Gumbel noise."""
        u = self._uniform((n_samples, k), device)
        u = torch.clamp_min(u, torch.finfo(u.dtype).tiny)
        return -torch.log(-torch.log(u))


def _fix_collisions(raw: torch.Tensor) -> torch.Tensor:
    """Map raw draws r_j in [0, n-j) (rows of (S, m)) to distinct values
    in [0, n): pick j steps past every earlier pick <= it, earlier picks
    taken in sorted order."""
    m = raw.shape[1]
    out = [raw[:, 0]]
    for j in range(1, m):
        prev = torch.sort(torch.stack(out, dim=1), dim=1).values
        r = raw[:, j]
        for i in range(j):
            r = r + (prev[:, i] <= r).to(r.dtype)
        out.append(r)
    return torch.stack(out, dim=1)


def _draw_without_replacement(draws, stream, n_samples: int,
                              n_valid: torch.Tensor,
                              m: int = MINIMAL_SAMPLE) -> torch.Tensor:
    """(S, m) rows of `m` distinct indices uniform over [0, n_valid)."""
    return _fix_collisions(draws.ranks(stream, n_samples, n_valid, m))


def _valid_first(valid_mask: torch.Tensor) -> torch.Tensor:
    """Rank -> position table: valid positions first, in index order.
    jnp.argsort is stable (sampling.py:78, :116); torch.argsort only with
    stable=True."""
    return torch.argsort((~valid_mask).to(torch.int32), stable=True)


def sample_indices(draws, stream, n_samples: int, valid_mask: torch.Tensor,
                   m: int = MINIMAL_SAMPLE) -> torch.Tensor:
    """(S, m) minimal-sample index tuples into the padded point array,
    each tuple distinct and drawn only from valid points."""
    n = valid_mask.shape[0]
    n_valid = valid_mask.sum()
    order = _valid_first(valid_mask)
    ranks = _draw_without_replacement(draws, stream, n_samples, n_valid, m)
    return order[torch.clamp(ranks, 0, n - 1)]


def localized_sample_indices(
    draws,
    stream,
    n_samples: int,
    valid_mask: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_ok: torch.Tensor | None = None,
    cluster: int = 4,
) -> torch.Tensor:
    """Locality-biased samples: a seed point plus `cluster - 1` of its
    k-NN neighbors, neighbor slots drawn without replacement by Gumbel
    top-(cluster-1) with a soft -20 penalty on slots where nbr_ok = 0."""
    n, k = nbr_idx.shape
    if cluster - 1 > k:
        raise ValueError((cluster, k))
    n_valid = valid_mask.sum()
    order = _valid_first(valid_mask)
    seeds = order[draws.seed_ranks(stream, n_samples, n_valid)]  # (S,)
    g = draws.gumbel(stream, n_samples, k, nbr_idx.device)
    if nbr_ok is not None:
        g = g + 20.0 * (nbr_ok[seeds] - 1.0)
    # jax.lax.top_k puts the lower index first among equal values; a
    # stable descending sort reproduces that order (torch.topk does not
    # promise one)
    slots = torch.sort(g, dim=1, descending=True, stable=True).indices
    slots = slots[:, :cluster - 1]
    picked = torch.gather(nbr_idx[seeds], 1, slots)
    return torch.cat([seeds[:, None], picked.to(seeds.dtype)], dim=1)
