"""PEARL labeling in PyTorch: exact k-NN graph, the banded symmetric
agreement operator, data costs, annealed mean-field and batched red-black
ICM over the Potts MRF.

Counterpart of ``multih_tpu/models/labeling.py`` for the banded paths:
the row-blocked exact k-NN build with the banded adjacency and its exact
far-edge list, and the windowed k-NN build with its far-free band, on
which the fused mean-field / ICM kernels (ops/kernels/mrf_kernel.py) run
on the card. The gather-path labeling (no banded adjacency) is not
ported; asking for it raises NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multih_tpu_torch.ops import geometry
from multih_tpu_torch.ops.kernels import mrf_kernel
from multih_tpu_torch.ops.sampling import window_roll
from multih_tpu_torch.ops.topk import top_k_stable

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


def knn_graph_windowed(feats: torch.Tensor, valid: torch.Tensor, k: int,
                       block: int):
    """k-NN inside the 3-block Morton window: each point's k nearest (in
    `feats` space, (N, 2) positions or (N, 4) sampling features) among
    the 3*block points of its own block and the two adjacent ones.
    Wrapped blocks, padding and self are penalised with 1e30; the k
    smallest come from k unrolled argmin-and-mask passes, lowest column
    first on ties (torch.argmin's order, as jnp.argmin's). Every edge
    lies in the band, so the banded adjacency needs no far list. At
    nb = 2 the window is the whole array and this is exact k-NN.

    Requires N % block == 0 and N >= 2*block. Returns (nbr_idx (N, k)
    int32, nbr_w (N, k) float {0,1}) like `knn_graph`."""
    n, d = feats.shape
    if n % block or n < 2 * block:
        raise ValueError((n, block))
    nb = n // block
    dev = feats.device
    fb = feats.reshape(nb, block, d)
    win = window_roll(feats, block)  # (nb, 3B, d)
    v_win = window_roll(valid, block)  # (nb, 3B)
    d2 = (fb * fb).sum(2)[:, :, None] + (win * win).sum(2)[:, None, :] \
        - 2.0 * torch.bmm(fb, win.transpose(1, 2))  # (nb, B, 3B)

    # window column c of block b is global index (b-1)*B + c; out of
    # range = a wrapped block
    b_ids = torch.arange(nb, device=dev)[:, None, None]
    g = (b_ids - 1) * block + torch.arange(3 * block, device=dev)[None, None]
    r_ids = b_ids * block + torch.arange(block, device=dev)[None, :, None]
    bad = (g < 0) | (g >= n) | (g == r_ids)
    d2 = d2 + _BIG * bad.to(d2.dtype)
    d2 = d2 + torch.where(v_win[:, None, :] > 0, 0.0, _BIG).to(d2.dtype)

    work = d2.reshape(n, 3 * block)
    col_iota = torch.arange(3 * block, device=dev)[None, :]
    cols, vals = [], []
    for _ in range(k):
        c = torch.argmin(work, dim=1)
        vals.append(work.amin(1))
        cols.append(c)
        work = work + _BIG * (col_iota == c[:, None]).to(work.dtype)
    col = torch.stack(cols, dim=1)
    best = torch.stack(vals, dim=1)
    blk_row = torch.arange(n, device=dev)[:, None] // block
    nbr_idx = torch.clamp((blk_row - 1) * block + col, 0, n - 1)
    edge_real = (best < _BIG * 0.5).to(feats.dtype)
    return nbr_idx.to(torch.int32), edge_real * valid[:, None]


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
    nbr: the far-free band's neighbour list, which the fused MRF kernels
      read (mrf_kernel.band_list), or None.
    """

    band: torch.Tensor
    far_out: torch.Tensor
    far_in: torch.Tensor
    far_w: torch.Tensor
    deg: torch.Tensor
    n_dropped: torch.Tensor
    nbr: mrf_kernel.NeighbourList | None = None

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
    neighbour_list: bool | None = None,
) -> BandedAdjacency:
    """The directed k-NN graph as the banded symmetric operator, general
    scatter path: each directed edge (i, j, w) adds 0.5 w to both (i<-j)
    and (j<-i); edges between non-adjacent blocks go to the far list
    (capacity default max(block, 0.75 N); overflow counted in n_dropped).
    far_capacity=0 takes the far-free build of a windowed graph
    (`_build_band_far_free`), which also builds the band's neighbour
    list for the fused MRF kernels when `neighbour_list` (default: when
    the band is a CUDA tensor), one launch of mrf_kernel.band_list.

    Scatter-adds are index_add_: weights are in {0, 0.5} and sums in
    {0, 0.5, 1}, all exact, so atomic order does not change the band."""
    n, k = nbr_idx.shape
    if n % block:
        raise ValueError((n, block))
    if far_capacity == 0:
        adj = _build_band_far_free(nbr_idx, nbr_w, block)
        if neighbour_list is None:
            neighbour_list = adj.band.is_cuda
        if neighbour_list:
            adj = adj._replace(nbr=mrf_kernel.band_list(adj.band))
        return adj
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


def _build_band_far_free(nbr_idx, nbr_w, block: int) -> BandedAdjacency:
    """The scatter-free build for a window-constrained graph
    (labeling.py:309-350): the forward band band_f holds 0.5 w of each
    row's own edges, and the reverse half is its block transpose,
      band of W^T at row block b = [R_{b-1}^T, M_b^T, L_{b+1}^T]
    for band_f[b] = [L_b, M_b, R_b]. The far arrays are empty; an edge
    outside the row's window (none exist for a windowed graph) is dropped
    and counted twice in n_dropped, as the scatter path counts both of
    its directions. The forward rows are a scatter_add_ of at most k
    values in {0, 0.5} per row: exact, like the JAX one-hot sum."""
    n, k = nbr_idx.shape
    nb = n // block
    dev = nbr_idx.device
    blk_row = torch.arange(n, device=dev)[:, None] // block
    col = nbr_idx.to(torch.int64) - (blk_row - 1) * block  # (N, k)
    in_band = (col >= 0) & (col < 3 * block)
    w_f = torch.where(in_band, 0.5 * nbr_w, 0.0)
    col = torch.clamp(col, 0, 3 * block - 1)
    band_f = torch.zeros((n, 3 * block), dtype=nbr_w.dtype, device=dev)
    band_f.scatter_add_(1, col, w_f)
    band_f = band_f.reshape(nb, block, 3 * block)
    l_blk = band_f[:, :, :block]
    m_blk = band_f[:, :, block:2 * block]
    r_blk = band_f[:, :, 2 * block:]
    band = band_f + torch.cat(
        [torch.roll(r_blk.transpose(1, 2), 1, dims=0),
         m_blk.transpose(1, 2),
         torch.roll(l_blk.transpose(1, 2), -1, dims=0)], dim=2,
    )
    deg = band.sum(2).reshape(n)
    n_dropped = 2 * (~in_band & (nbr_w > 0)).sum().to(torch.int32)
    empty_i = torch.zeros((0,), dtype=torch.int64, device=dev)
    return BandedAdjacency(
        band=band.contiguous(), far_out=empty_i, far_in=empty_i,
        far_w=torch.zeros((0,), dtype=nbr_w.dtype, device=dev),
        deg=deg[:, None], n_dropped=n_dropped,
    )


def _mrf_kernel_ok(adj: BandedAdjacency | None) -> bool:
    """The fused MRF kernels need a far-edge-free banded adjacency."""
    return adj is not None and adj.far_w.shape[0] == 0


def _require_band(adj):
    if adj is None:
        raise NotImplementedError(
            "the gather/scatter agreement path (no banded adjacency) is "
            "not ported yet"
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
    _require_band(adj)
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
    JAX lax.scan over temperatures (labeling.py:640) is a Python loop.
    With `use_kernel` and a far-free band, all sweeps run in the fused
    kernel (mrf_kernel.mean_field_fused), one call."""
    _require_band(adj)
    q = torch.softmax(-dct, dim=0) if q_init is None else q_init
    temps = _mf_temps(iterations, temp_start, temp_end, dct.dtype,
                      dct.device)
    if use_kernel and _mrf_kernel_ok(adj):
        base = dct + spatial_weight * adj.deg.T  # (L, N)
        return mrf_kernel.mean_field_fused(
            q.contiguous(), base.contiguous(), adj.band, 1.0 / temps,
            spatial_weight, nbr=adj.nbr,
        )
    deg = adj.deg.T  # (1, N)
    for i in range(temps.shape[0]):
        pair = spatial_weight * (deg - adj.agree_t(q))
        q = torch.softmax(-(dct + pair) / temps[i], dim=0)
    return q


def pack_front(x1, x2, valid, Hs, active, spatial_weight: float,
               adj: BandedAdjacency):
    """The fused front's packed inputs (labeling.py:676-694): the points
    (8, N) as [x1x, x1y, x2x, x2y, valid, sw*deg, 0, 0], the labels
    (K+1, 19) as [H, adj(H), active] with an all-zero outlier row."""
    dt = torch.float32
    n = x1.shape[0]
    zeros = torch.zeros((n,), dtype=dt, device=x1.device)
    pts = torch.stack([
        x1[:, 0], x1[:, 1], x2[:, 0], x2[:, 1], valid,
        spatial_weight * adj.deg[:, 0], zeros, zeros,
    ]).to(dt)
    k = Hs.shape[0]
    hm = torch.cat([Hs.reshape(k, 9), geometry.adjugate_3x3(Hs).reshape(k, 9),
                    active.reshape(k, 1)], dim=1).to(dt)
    hm = torch.cat([hm, torch.zeros((1, 19), dtype=dt, device=hm.device)])
    return pts, hm


def pearl_relax_fused(x1, x2, valid, Hs, active, thr, outlier_cost: float,
                      spatial_weight: float, iterations: int,
                      temp_start: float, temp_end: float, q_init,
                      adj: BandedAdjacency, kind: str = "symmetric",
                      use_kernel: bool = False):
    """residual_matrix -> data_costs_t -> mean_field_t as one fused call
    (labeling.py:652) on `pack_front`'s inputs. `use_kernel` runs the
    CUDA kernel (mrf_kernel.mean_field_fused_front), else its plain
    version. Homography transfer / symmetric kinds and a far-free band
    only. Returns (q, dct, r) for the rest of the PEARL iteration."""
    pts, hm = pack_front(x1, x2, valid, Hs, active, spatial_weight, adj)
    temps = _mf_temps(iterations, temp_start, temp_end, torch.float32,
                      x1.device)
    front = (mrf_kernel.mean_field_fused_front if use_kernel
             else mrf_kernel.mean_field_fused_front_reference)
    return front(q_init.to(torch.float32).contiguous(), pts, hm, adj.band,
                 1.0 / temps, thr, spatial_weight, outlier_cost, kind=kind,
                 nbr=adj.nbr)


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
    has lower energy. The fori_loop (labeling.py:869) is a Python loop;
    with `use_kernel` and a far-free band the half-sweeps run in the
    fused kernel (mrf_kernel.icm_fused), one call."""
    _require_band(adj)
    if use_kernel and _mrf_kernel_ok(adj):
        base = dct + spatial_weight * adj.deg.T  # (L, N)
        labels = mrf_kernel.icm_fused(
            starts.to(torch.int32).contiguous(), base.contiguous(),
            adj.band, iterations, spatial_weight, nbr=adj.nbr,
        ).to(starts.dtype)
    else:
        labels = _icm_sweeps(starts, dct, spatial_weight, iterations, adj)
    e_cur = _energies_batch(labels, dct, adj, spatial_weight)
    e_const = dct.sum(1)
    return torch.where((e_const.min() < e_cur)[:, None],
                       torch.argmin(e_const).to(labels.dtype), labels)


def _icm_sweeps(starts, dct, spatial_weight: float, iterations: int,
                adj: BandedAdjacency):
    """The red-black half-sweeps of `_icm_batch`, plain PyTorch."""
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
    return labels


def best_labeling_t(starts, dct, nbr_idx, nbr_w, spatial_weight: float,
                    icm_iterations: int, adj=None, use_kernel: bool = False):
    """ICM from several start labelings, batched; returns the
    lowest-energy result (first on ties)."""
    _require_band(adj)
    stacked = torch.stack(starts)
    polished = _icm_batch(stacked, dct, spatial_weight, icm_iterations,
                          adj, use_kernel=use_kernel)
    energies = _energies_batch(polished, dct, adj, spatial_weight)
    return polished.index_select(0, torch.argmin(energies).view(1))[0]
