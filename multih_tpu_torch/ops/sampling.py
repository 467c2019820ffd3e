"""Minimal-sample index draws for hypothesis generation (PyTorch).

Counterpart of ``multih_tpu/ops/sampling.py``. The JAX package draws with
threefry counter keys; PyTorch cannot reproduce those bits, so every
random number enters through a small *draw source* object: `ranks`,
`seed_ranks` and `gumbel` for the row-gather sampler, `window_ranks`,
`window_randint` and `gumbel` for the window-stratified one.
`TorchDraws` is the default: one ``torch.Generator``. The parity tests
pass a source that replays the JAX fit's own threefry draws, so both
packages sample the same indices.

A draw source takes a `stream` argument first: an opaque tag of the
call site (the progressive round, or ("win_u" | "win_s" | "win_n",
round) for the windowed sampler's three draws), which a replaying
source maps to the JAX key of that call and `TorchDraws` ignores.
"""

from __future__ import annotations

import torch

from multih_tpu_torch.ops.kernels import gather_kernel
from multih_tpu_torch.ops.topk import top_k_stable

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
        return self.window_ranks(stream, n_valid.expand(n_samples), m)

    def seed_ranks(self, stream, n_samples: int,
                   n_valid: torch.Tensor) -> torch.Tensor:
        """(S,) seed ranks uniform in [0, max(n_valid, 1))."""
        hi = torch.clamp_min(n_valid, 1)
        r = torch.floor(self._uniform((n_samples,), n_valid.device)
                        * hi).long()
        return torch.minimum(r, hi - 1)

    def window_ranks(self, stream, n_valid: torch.Tensor,
                     m: int) -> torch.Tensor:
        """(S, m) raw draws, row s uniform in [0, max(n_valid[s] - j, 1))
        for an (S,) n_valid."""
        hi = torch.clamp_min(
            n_valid[:, None] - torch.arange(m, device=n_valid.device), 1
        )  # (S, m)
        r = torch.floor(self._uniform(hi.shape, n_valid.device) * hi).long()
        return torch.minimum(r, hi - 1)

    def window_randint(self, stream, lo: torch.Tensor, hi: torch.Tensor,
                       n: int) -> torch.Tensor:
        """(R, n) integers, row r uniform in [lo[r], hi[r]) for (R, 1)
        bounds with hi > lo."""
        span = hi - lo
        u = self._uniform((lo.shape[0], n), lo.device)
        return lo + torch.minimum(torch.floor(u * span).long(), span - 1)

    def gumbel(self, stream, shape, device) -> torch.Tensor:
        """Standard Gumbel noise of `shape`."""
        u = self._uniform(shape, device)
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
    g = draws.gumbel(stream, (n_samples, k), nbr_idx.device)
    if nbr_ok is not None:
        g = g + 20.0 * (nbr_ok[seeds] - 1.0)
    # jax.lax.top_k puts the lower index first among equal values; a
    # stable descending sort reproduces that order (torch.topk does not
    # promise one)
    slots = torch.sort(g, dim=1, descending=True, stable=True).indices
    slots = slots[:, :cluster - 1]
    picked = torch.gather(nbr_idx[seeds], 1, slots)
    return torch.cat([seeds[:, None], picked.to(seeds.dtype)], dim=1)


def window_roll(a: torch.Tensor, block: int) -> torch.Tensor:
    """(N, ...) -> (nb, 3B, ...): each block's 3-block Morton window, the
    previous block first, wrapped at the ends (sampling.py:130; callers
    neutralise the wrap thirds, never by branching)."""
    ab = a.reshape(a.shape[0] // block, block, *a.shape[1:])
    return torch.cat([torch.roll(ab, 1, dims=0), ab,
                      torch.roll(ab, -1, dims=0)], dim=1)


# channels of the windowed source (cum: gather_kernel.CUM_CH)
AVAIL_CH, POS_CH, NBR_CH = 4, 6, 7


def window_source(x1, x2, avail, nbr_idx, block: int) -> torch.Tensor:
    """The (nb, 3B, C) windowed source rows of `windowed_quadruples`:
    channels [x1x x1y x2x x2y avail cum pos nbr_0..k-1], zero-padded as
    sampling.py:219 pads them (its count 5 + k + 3 is one over the 7 + k
    channels, so C=15, not 16, at k=6). The wrap thirds' availability is
    zeroed before the cumsum, so no rank ever selects them
    (sampling.py:205-227); cum and pos are exact small integers in
    float32."""
    n, k = nbr_idx.shape
    nb = n // block
    f32 = torch.float32
    base = torch.cat([x1.to(f32), x2.to(f32), avail.to(f32)[:, None],
                      nbr_idx.to(f32)], dim=1)  # (N, 5 + k)
    win = window_roll(base, block)  # (nb, 3B, 5 + k)
    a_w = win[:, :, AVAIL_CH].clone()
    a_w[0, :block] = 0.0
    a_w[nb - 1, 2 * block:] = 0.0
    cum = torch.cumsum(a_w, dim=1)
    pos = torch.arange(3 * block, dtype=f32, device=x1.device)
    pos = pos[None, :].expand(nb, -1)
    c_tot = 5 + k + 3
    pad = torch.zeros((nb, 3 * block, (-c_tot) % 8), dtype=f32,
                      device=x1.device)
    return torch.cat([win[:, :, :4], a_w[..., None], cum[..., None],
                      pos[..., None], win[:, :, 5:], pad], dim=2)


def windowed_quadruples(draws, stream, x1, x2, avail, nbr_idx,
                        n_samples: int, block: int,
                        use_kernel: bool = False,
                        window_range=None) -> torch.Tensor:
    """Window-stratified minimal samples (sampling.py:143): the (32, S)
    coordinate-major rows `pipeline._solve_from_gt` takes (row 8q+c =
    channel c of quad point q; channel 4 = avail).

    Sample slot range [v*S/nb, (v+1)*S/nb) belongs to Morton window v,
    its uniform half first: 4 distinct ranks among the window's
    available rows (gathered in "rank" mode), then a seed ranked in the
    middle block's available rows (the whole window if that is
    exhausted) plus 3 of its k-NN neighbours by Gumbel top-3, gathered
    by window-local index. Windows without available points give zero
    columns, which the solve discards. `use_kernel` gathers with the
    CUDA window_gather kernel, else with its plain version.

    Requires N % block == 0, n_samples % (N // block) == 0 and a
    window-constrained nbr_idx (labeling.knn_graph_windowed).

    `window_range=(w0, nw)` returns only windows [w0, w0 + nw)'s columns,
    the slot range [w0 * S/nb, (w0 + nw) * S/nb) (sampling.py:251): every
    draw is made full-size, as in the unsharded call, and only the
    gathers run on the slice, so the shards' columns concatenate to the
    unsharded call's bit for bit."""
    n, k = nbr_idx.shape
    nb = n // block
    if n % block or n_samples % nb:
        raise ValueError((n, block, n_samples))
    sg = n_samples // nb
    sg_l = sg // 2
    sg_u = sg - sg_l
    dev = x1.device

    win_all = window_source(x1, x2, avail, nbr_idx, block)
    cum = win_all[:, :, gather_kernel.CUM_CH]
    m = cum[:, -1].to(torch.int64)  # available rows per window

    # uniform half: 4 distinct ranks among the window's available rows
    raw = draws.window_ranks(("win_u", stream),
                             m.repeat_interleave(sg_u), MINIMAL_SAMPLE)
    ranks_u = _fix_collisions(raw).reshape(nb, sg_u * MINIMAL_SAMPLE)

    # localized half: a seed rank in the middle block's available rows
    c_lo = cum[:, block - 1].to(torch.int64)
    c_hi = cum[:, 2 * block - 1].to(torch.int64)
    has_mid = c_hi > c_lo
    lo = torch.where(has_mid, c_lo, 0)[:, None]
    hi = torch.where(has_mid, c_hi, torch.clamp_min(m, 1))[:, None]
    ranks_s = draws.window_randint(("win_s", stream), lo,
                                   torch.maximum(hi, lo + 1), sg_l)
    g = draws.gumbel(("win_n", stream), (nb, sg_l, k), dev)

    # a dim-0 slice of the contiguous source keeps every window 16-byte
    # aligned, as the kernel needs (its window is a multiple of 16 bytes)
    w0, nw = (0, nb) if window_range is None else window_range
    if not (0 <= w0 and 0 < nw and w0 + nw <= nb):
        raise ValueError(f"window_range {window_range} of {nb} windows")
    win_all, ranks_u, ranks_s, g = (a[w0:w0 + nw] for a in
                                    (win_all, ranks_u, ranks_s, g))

    gather = (gather_kernel.window_gather if use_kernel
              else gather_kernel.window_gather_reference)
    sel_rank = torch.cat([ranks_u, ranks_s], dim=1).to(torch.int32)
    out_r = gather(win_all, sel_rank.contiguous(), "rank")  # (nw, C, T)
    u_part = out_r[:, :8, :sg_u * MINIMAL_SAMPLE]
    s_part = out_r[:, :, sg_u * MINIMAL_SAMPLE:]

    seed_loc = s_part[:, POS_CH, :]  # (nw, Sg_l) window-local position
    nbr_rows = s_part[:, NBR_CH:NBR_CH + k, :].transpose(1, 2)  # (nw,Sg_l,k)
    # sampling.py:284: jax.lax.top_k tie order
    _, slots = top_k_stable(g, 3)
    picked = torch.gather(nbr_rows, 2, slots)  # (nw, Sg_l, 3) global
    v_off = ((torch.arange(w0, w0 + nw, dtype=torch.float32, device=dev)
              - 1.0) * block)[:, None, None]
    quad_loc = torch.cat([seed_loc[:, :, None], picked - v_off], dim=2)
    quad_loc = quad_loc.reshape(nw, sg_l * MINIMAL_SAMPLE).to(torch.int32)
    out_i = gather(win_all[:, :, :8].contiguous(), quad_loc.contiguous(),
                   "index")

    def to_rows(part, s_count):  # (nw, 8, s*4) -> (32, nw, s)
        return part.reshape(nw, 8, s_count, MINIMAL_SAMPLE).permute(
            3, 1, 0, 2).reshape(32, nw, s_count)

    return torch.cat([to_rows(u_part, sg_u), to_rows(out_i, sg_l)],
                     dim=2).reshape(32, nw * sg)
