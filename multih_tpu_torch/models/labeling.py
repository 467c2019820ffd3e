"""PEARL labeling in PyTorch: exact k-NN graph, the banded symmetric
agreement operator, data costs, annealed mean-field and batched red-black
ICM over the Potts MRF.

Counterpart of ``multih_tpu/models/labeling.py`` for the slice the port
runs: the row-blocked exact k-NN build and the banded adjacency with its
exact far-edge list. The windowed k-NN build, the far-free band and the
fused mean-field / ICM kernels that need it are not ported yet; asking
for them raises NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multih_tpu_torch.models.selection import top_k_stable

_BIG = 1e30


# ---------------------------------------------------------------------------
# k-NN neighborhood graph
# ---------------------------------------------------------------------------

def knn_graph(pts: torch.Tensor, valid: torch.Tensor, k: int,
              row_block: int = 0, approx: bool = False):
    """Exact spatial k-NN: dense for N <= 4096, `row_block`-row blocks
    above (row_block <= 0 = auto, 2048). Padded points never appear as
    neighbors. `approx` is accepted for config parity and ignored: the
    port always takes the exact top-k (the JAX package's
    `lax.approx_max_k` is exact on the CPU as well).

    Returns (nbr_idx (N, k) int32, nbr_w (N, k) float {0,1})."""
    n = pts.shape[0]
    if row_block <= 0:
        row_block = n if n <= 4096 else 2048
    sq = (pts * pts).sum(1)
    col_pen = torch.where(valid > 0, 0.0, _BIG).to(pts.dtype)
    col_idx = torch.arange(n, device=pts.device)

    idxs, reals = [], []
    for r0 in range(0, n, row_block):
        p_blk = pts[r0:r0 + row_block]
        i_blk = col_idx[r0:r0 + row_block]
        d2 = (p_blk * p_blk).sum(1)[:, None] + sq[None, :] \
            - 2.0 * (p_blk @ pts.T)
        d2 = d2 + col_pen[None, :]
        d2 = d2 + _BIG * (i_blk[:, None] == col_idx[None, :]).to(d2.dtype)
        # labeling.py:83: jax.lax.top_k tie order via a stable sort
        neg_d2, idx = top_k_stable(-d2, k)
        idxs.append(idx.to(torch.int32))
        reals.append((-neg_d2 < _BIG * 0.5).to(pts.dtype))
    nbr_idx = torch.cat(idxs)
    nbr_w = torch.cat(reals) * valid[:, None]
    return nbr_idx, nbr_w


# ---------------------------------------------------------------------------
# symmetrized neighbor agreement operator
# ---------------------------------------------------------------------------

class BandedAdjacency(NamedTuple):
    """Symmetrized k-NN adjacency in block-tridiagonal + far-edge form.

    band: (nb, B, 3B) float32 — band[b, r, c] = w_sym between global row
      b*B+r and global column (b-1)*B+c. Kept in float32 (the JAX
      package stores bf16; both are exact for the {0, 0.5, 1} weights).
    far_out, far_in, far_w: (F,) — exact fixup for edges crossing more
      than one block (zero-padded).
    deg: (N, 1) — symmetrized degree.
    n_dropped: () int32 — far edges beyond capacity F.
    """

    band: torch.Tensor
    far_out: torch.Tensor
    far_in: torch.Tensor
    far_w: torch.Tensor
    deg: torch.Tensor
    n_dropped: torch.Tensor

    @property
    def block(self) -> int:
        return self.band.shape[1]

    def agree_t(self, p_t: torch.Tensor) -> torch.Tensor:
        """Label-major agreement: agree[:, i] = sum_j w_sym_ij p_t[:, j];
        p_t is (L, N), returns (L, N)."""
        nb, b, _ = self.band.shape
        l = p_t.shape[0]
        pb = p_t.reshape(l, nb, b)
        win = torch.cat(
            [torch.roll(pb, 1, dims=1), pb, torch.roll(pb, -1, dims=1)],
            dim=2,
        )  # (L, nb, 3B); wrap rows hit only zero band entries
        out = torch.bmm(win.transpose(0, 1), self.band.transpose(1, 2))
        out = out.transpose(0, 1).reshape(l, -1)  # (L, N)
        if self.far_w.shape[0] == 0:
            return out
        # labeling.py:279 scatter-add -> index_add_; the far fixup adds
        # float probabilities, so on CUDA its atomic order moves the last
        # bits from run to run
        contrib = p_t[:, self.far_in] * self.far_w[None, :]
        return out.index_add_(1, self.far_out, contrib)


def build_banded_adjacency(
    nbr_idx: torch.Tensor,
    nbr_w: torch.Tensor,
    block: int = 256,
    far_capacity: int | None = None,
) -> BandedAdjacency:
    """The directed k-NN graph as the banded symmetric operator, general
    scatter path: each directed edge (i, j, w) adds 0.5 w to both (i<-j)
    and (j<-i); edges between non-adjacent blocks go to the far list
    (capacity default max(block, 0.75 N); overflow counted in n_dropped).

    Scatter-adds are index_add_: weights are in {0, 0.5} and sums in
    {0, 0.5, 1}, all exact, so atomic order does not change the band."""
    n, k = nbr_idx.shape
    if n % block:
        raise ValueError((n, block))
    if far_capacity == 0:
        raise NotImplementedError(
            "the far-free band of the windowed k-NN graph is not ported "
            "yet (it ships with the fused MRF kernels)"
        )
    if far_capacity is None:
        far_capacity = max(block, (3 * n) // 4)
    nb = n // block
    dev = nbr_idx.device

    i_idx = torch.arange(n, dtype=torch.int64, device=dev).repeat_interleave(k)
    j_idx = nbr_idx.reshape(-1).to(torch.int64)
    w_half = 0.5 * nbr_w.reshape(-1)
    out_e = torch.cat([i_idx, j_idx])
    in_e = torch.cat([j_idx, i_idx])
    w_e = torch.cat([w_half, w_half])

    blk_out = out_e // block
    blk_in = in_e // block
    near = (blk_out - blk_in).abs() <= 1
    live = w_e > 0

    col = in_e - (blk_out - 1) * block
    w_near = torch.where(near & live, w_e, 0.0)
    col = torch.where(near, col, 0)
    band = torch.zeros(n * 3 * block, dtype=nbr_w.dtype, device=dev)
    band.index_add_(0, out_e * (3 * block) + col, w_near)
    band = band.reshape(nb, block, 3 * block)

    # far part: compact far-live edges to the front (stable argsort, as
    # labeling.py:382), cap at capacity
    is_far = ~near & live
    order = torch.argsort((~is_far).to(torch.int32), stable=True)
    sel = order[:far_capacity]
    far_live = is_far[sel]
    far_out = torch.where(far_live, out_e[sel], 0)
    far_in = torch.where(far_live, in_e[sel], 0)
    far_w = torch.where(far_live, w_e[sel], 0.0)
    n_far = is_far.sum().to(torch.int32)
    n_dropped = torch.clamp_min(n_far - far_capacity, 0)

    deg = band.sum(2).reshape(n)
    deg = deg.index_add(0, far_out, far_w)
    return BandedAdjacency(
        band=band, far_out=far_out, far_in=far_in, far_w=far_w,
        deg=deg[:, None], n_dropped=n_dropped,
    )


def _mrf_kernel_ok(adj: BandedAdjacency | None) -> bool:
    """The fused MRF kernels need a far-edge-free banded adjacency."""
    return adj is not None and adj.far_w.shape[0] == 0


def _require_band(adj, use_kernel):
    if adj is None:
        raise NotImplementedError(
            "the gather/scatter agreement path (no banded adjacency) is "
            "not ported yet"
        )
    if use_kernel and _mrf_kernel_ok(adj):
        raise NotImplementedError(
            "the fused mean-field / ICM kernels are not ported yet"
        )


# ---------------------------------------------------------------------------
# energy terms
# ---------------------------------------------------------------------------

def data_costs_t(residuals, valid, threshold_sq, outlier_cost: float,
                 active):
    """(K, N) residuals -> (K+1, N) label-major costs: the truncated
    quadratic min(r / tau^2, 8) * outlier_cost, +1e6 on inactive planes,
    the outlier row last, zero on padded points."""
    k, n = residuals.shape
    plane = torch.clamp_max(residuals / threshold_sq, 8.0) * outlier_cost
    plane = plane + (1.0 - active)[:, None] * 1e6
    out = torch.full((1, n), outlier_cost, dtype=residuals.dtype,
                     device=residuals.device)
    return torch.cat([plane, out], dim=0) * valid[None, :]


def _onehot_t(labels, l, dtype):
    """(..., N) labels -> (..., L, N) one-hot, label-major."""
    ids = torch.arange(l, dtype=labels.dtype, device=labels.device)
    return (labels[..., None, :] == ids[:, None]).to(dtype)


def _potts_t(labels, adj: BandedAdjacency, dct):
    """Potts energy 0.5 * sum_i (deg_i - agree_onehot[l_i, i])."""
    onehot = _onehot_t(labels, dct.shape[0], dct.dtype)
    own = (onehot * adj.agree_t(onehot)).sum(0)
    return 0.5 * (adj.deg[:, 0] - own).sum()


def total_energy_t(labels, dct, nbr_idx, nbr_w, spatial_weight: float,
                   label_cost: float, active, adj=None):
    """E(L) = data + lambda * Potts + beta * |used active labels|."""
    _require_band(adj, False)
    l = dct.shape[0]
    oh = _onehot_t(labels, l, dct.dtype)
    e_data = (oh * dct).sum()
    e_smooth = spatial_weight * _potts_t(labels, adj, dct)
    used = oh[:l - 1].amax(1) > 0
    e_label = label_cost * (used & (active > 0)).sum()
    return e_data + e_smooth + e_label


# ---------------------------------------------------------------------------
# mean-field relaxation + ICM polish
# ---------------------------------------------------------------------------

def _mf_temps(iterations, temp_start, temp_end, dtype, device):
    """Geometric annealing schedule temp_start -> temp_end."""
    if iterations <= 1:
        return torch.full((max(iterations, 1),), temp_end, dtype=dtype,
                          device=device)
    ratio = (temp_end / temp_start) ** (1.0 / (iterations - 1))
    return temp_start * ratio ** torch.arange(iterations, dtype=dtype,
                                              device=device)


def mean_field_t(dct, nbr_idx, nbr_w, spatial_weight: float,
                 iterations: int, temp_start: float, temp_end: float,
                 q_init=None, adj=None, use_kernel: bool = False):
    """Annealed mean-field for the Potts MRF, label-major (L, N):
    q <- softmax_l(-(D + lambda (deg - agree(q))) / T) per sweep. The
    JAX lax.scan over temperatures (labeling.py:640) is a Python loop."""
    _require_band(adj, use_kernel)
    q = torch.softmax(-dct, dim=0) if q_init is None else q_init
    temps = _mf_temps(iterations, temp_start, temp_end, dct.dtype,
                      dct.device)
    deg = adj.deg.T  # (1, N)
    for i in range(temps.shape[0]):
        pair = spatial_weight * (deg - adj.agree_t(q))
        q = torch.softmax(-(dct + pair) / temps[i], dim=0)
    return q


def _energies_batch(labels, dct, adj: BandedAdjacency, spatial_weight):
    """(S, N) labelings -> (S,) data + lambda * Potts energies."""
    s, n = labels.shape
    l = dct.shape[0]
    onehot = _onehot_t(labels, l, dct.dtype)  # (S, L, N)
    e_data = (onehot * dct[None]).sum((1, 2))
    agree = adj.agree_t(onehot.reshape(s * l, n)).reshape(s, l, n)
    own = (onehot * agree).sum(1)
    e_potts = 0.5 * (adj.deg[None, :, 0] - own).sum(1)
    return e_data + spatial_weight * e_potts


def _icm_batch(starts, dct, spatial_weight: float, iterations: int,
               adj: BandedAdjacency, use_kernel: bool = False):
    """Red-black ICM from S start labelings at once, (S, N) -> (S, N):
    each half-sweep moves the points of one index parity to their
    cheapest label when it beats the current one by more than 1e-6, then
    the constant-labeling escape adopts the best constant labeling if it
    has lower energy. The fori_loop (labeling.py:869) is a Python loop."""
    _require_band(adj, use_kernel)
    s, n = starts.shape
    l = dct.shape[0]
    deg = adj.deg.T  # (1, N)
    parity = torch.arange(n, device=starts.device) % 2

    def half(labels, par):
        onehot = _onehot_t(labels, l, dct.dtype)  # (S, L, N)
        agree = adj.agree_t(onehot.reshape(s * l, n)).reshape(s, l, n)
        cost = dct[None] + spatial_weight * (deg[None] - agree)
        # first minimum on ties, as the JAX compare-select chain
        new_c, new = cost.min(dim=1)
        cur_c = (onehot * cost).sum(1)
        move = (new_c < cur_c - 1e-6) & (parity[None, :] == par)
        return torch.where(move, new.to(labels.dtype), labels)

    labels = starts
    for _ in range(iterations):
        labels = half(labels, 0)
        labels = half(labels, 1)

    e_cur = _energies_batch(labels, dct, adj, spatial_weight)
    e_const = dct.sum(1)
    return torch.where((e_const.min() < e_cur)[:, None],
                       torch.argmin(e_const).to(labels.dtype), labels)


def best_labeling_t(starts, dct, nbr_idx, nbr_w, spatial_weight: float,
                    icm_iterations: int, adj=None, use_kernel: bool = False):
    """ICM from several start labelings, batched; returns the
    lowest-energy result (first on ties)."""
    _require_band(adj, use_kernel)
    stacked = torch.stack(starts)
    polished = _icm_batch(stacked, dct, spatial_weight, icm_iterations,
                          adj, use_kernel=use_kernel)
    energies = _energies_batch(polished, dct, adj, spatial_weight)
    return polished.index_select(0, torch.argmin(energies).view(1))[0]
