"""PEARL labeling in PyTorch: exact k-NN graph, the banded symmetric
agreement operator, data costs, annealed mean-field and batched red-black
ICM over the Potts MRF.

Counterpart of ``multih_tpu/models/labeling.py``: the row-blocked exact
k-NN build with the banded adjacency and its exact far-edge list, the
windowed k-NN build with its far-free band, on which the fused
mean-field / ICM kernels (ops/kernels/mrf_kernel.py) run on the card,
and the gather path (``adj=None``): the symmetrized agreement as a
gather plus an ``index_add_`` over the k-NN graph itself, for points in
any order and any N (no kernel: it runs in plain PyTorch everywhere).
On a 'pt' mesh (`PointShard`) a rank builds its own blocks' rows of the
graph (windowed or exact) and of the band (`shard_adjacency`), and every
sweep and energy reads its neighbours' edge blocks through a halo
exchange, and on the exact graph the columns of its far edges through
one all_gather.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multih_tpu_torch.ops.kernels import mrf_kernel
from multih_tpu_torch.ops.sampling import window_roll
from multih_tpu_torch.ops.topk import top_k_stable

_BIG = 1e30


# ---------------------------------------------------------------------------
# k-NN neighborhood graph
# ---------------------------------------------------------------------------

def knn_graph(pts: torch.Tensor, valid: torch.Tensor, k: int,
              row_block: int = 0, approx: bool = False,
              rows: tuple[int, int] | None = None):
    """Exact spatial k-NN: dense for N <= 4096, `row_block`-row blocks
    above (row_block <= 0 = auto, 2048). Padded points never appear as
    neighbors. `approx` is accepted for config parity and ignored: the
    port always takes the exact top-k (the JAX package's
    `lax.approx_max_k` is exact on the CPU as well).

    Returns (nbr_idx (N, k) int32, nbr_w (N, k) float {0,1}); with
    `rows` = (lo, hi), only the rows of points lo..hi-1 (a 'pt' rank's
    own points) against all N, each as the whole graph has it."""
    n = pts.shape[0]
    lo, hi = (0, n) if rows is None else rows
    if row_block <= 0:
        row_block = n if n <= 4096 else 2048
    sq = (pts * pts).sum(1)
    col_pen = torch.where(valid > 0, 0.0, _BIG).to(pts.dtype)
    col_idx = torch.arange(n, device=pts.device)

    idxs, reals = [], []
    for r0 in range(lo, hi, row_block):
        p_blk = pts[r0:min(r0 + row_block, hi)]
        i_blk = col_idx[r0:min(r0 + row_block, hi)]
        d2 = (p_blk * p_blk).sum(1)[:, None] + sq[None, :] \
            - 2.0 * (p_blk @ pts.T)
        d2 = d2 + col_pen[None, :]
        d2 = d2 + _BIG * (i_blk[:, None] == col_idx[None, :]).to(d2.dtype)
        # labeling.py:83: jax.lax.top_k tie order via a stable sort
        neg_d2, idx = top_k_stable(-d2, k)
        idxs.append(idx.to(torch.int32))
        reals.append((-neg_d2 < _BIG * 0.5).to(pts.dtype))
    nbr_idx = torch.cat(idxs)
    nbr_w = torch.cat(reals) * valid[lo:hi, None]
    return nbr_idx, nbr_w


def knn_graph_windowed(feats: torch.Tensor, valid: torch.Tensor, k: int,
                       block: int, rows: tuple[int, int] | None = None):
    """k-NN inside the 3-block Morton window: each point's k nearest (in
    `feats` space, (N, 2) positions or (N, 4) sampling features) among
    the 3*block points of its own block and the two adjacent ones.
    Wrapped blocks, padding and self are penalised with 1e30; the k
    smallest come from k unrolled argmin-and-mask passes, lowest column
    first on ties (torch.argmin's order, as jnp.argmin's). Every edge
    lies in the band, so the banded adjacency needs no far list. At
    nb = 2 the window is the whole array and this is exact k-NN.

    Requires N % block == 0 and N >= 2*block. Returns (nbr_idx (N, k)
    int32, nbr_w (N, k) float {0,1}) like `knn_graph`; with `rows` =
    (lo, hi), block-aligned, only the rows of points lo..hi-1 (a 'pt'
    rank's own blocks), each as the whole graph has it."""
    n, d = feats.shape
    if n % block or n < 2 * block:
        raise ValueError((n, block))
    lo, hi = (0, n) if rows is None else rows
    if lo % block or hi % block or not 0 <= lo < hi <= n:
        raise ValueError(f"rows {rows} not block-aligned in N={n}")
    nb = n // block
    b0, b1 = lo // block, hi // block
    dev = feats.device
    fb = feats[lo:hi].reshape(b1 - b0, block, d)
    # each block's 3-block window, wrapped at the ends (window_roll's)
    src = ((torch.arange(b0 - 1, b1 + 1, device=dev) % nb)[:, None] * block
           + torch.arange(block, device=dev)[None, :]).reshape(-1)
    win = window_roll(feats[src], block)[1:-1]  # (nb, 3B, d)
    v_win = window_roll(valid[src], block)[1:-1]  # (nb, 3B)
    d2 = (fb * fb).sum(2)[:, :, None] + (win * win).sum(2)[:, None, :] \
        - 2.0 * torch.bmm(fb, win.transpose(1, 2))  # (nb, B, 3B)

    # window column c of block b is global index (b-1)*B + c; out of
    # range = a wrapped block
    b_ids = torch.arange(b0, b1, device=dev)[:, None, None]
    g = (b_ids - 1) * block + torch.arange(3 * block, device=dev)[None, None]
    r_ids = b_ids * block + torch.arange(block, device=dev)[None, :, None]
    bad = (g < 0) | (g >= n) | (g == r_ids)
    d2 = d2 + _BIG * bad.to(d2.dtype)
    d2 = d2 + torch.where(v_win[:, None, :] > 0, 0.0, _BIG).to(d2.dtype)

    work = d2.reshape(hi - lo, 3 * block)
    col_iota = torch.arange(3 * block, device=dev)[None, :]
    cols, vals = [], []
    for _ in range(k):
        c = torch.argmin(work, dim=1)
        vals.append(work.amin(1))
        cols.append(c)
        work = work + _BIG * (col_iota == c[:, None]).to(work.dtype)
    col = torch.stack(cols, dim=1)
    best = torch.stack(vals, dim=1)
    blk_row = torch.arange(lo, hi, device=dev)[:, None] // block
    nbr_idx = torch.clamp((blk_row - 1) * block + col, 0, n - 1)
    edge_real = (best < _BIG * 0.5).to(feats.dtype)
    return nbr_idx.to(torch.int32), edge_real * valid[lo:hi, None]


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
    nbr: the far-free band's neighbour list (mrf_kernel.band_list), or
      None. The fused MRF kernels run exactly where the adjacency carries
      it; the fit builds it where its kernels are on
      (pipeline._kernels_enabled), and elsewhere the same sweeps run in
      their plain versions.
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
    neighbour_list: bool = False,
) -> BandedAdjacency:
    """The directed k-NN graph as the banded symmetric operator, general
    scatter path: each directed edge (i, j, w) adds 0.5 w to both (i<-j)
    and (j<-i); edges between non-adjacent blocks go to the far list
    (capacity default max(block, 0.75 N); overflow counted in n_dropped).
    far_capacity=0 takes the far-free build of a windowed graph
    (`_build_band_far_free`), which also builds the band's neighbour
    list for the fused MRF kernels when `neighbour_list` (a CUDA band),
    one launch of mrf_kernel.band_list.

    Scatter-adds are index_add_: weights are in {0, 0.5} and sums in
    {0, 0.5, 1}, all exact, so atomic order does not change the band."""
    n, k = nbr_idx.shape
    if n % block:
        raise ValueError((n, block))
    if far_capacity == 0:
        adj = _build_band_far_free(nbr_idx, nbr_w, block)
        if neighbour_list:
            adj = adj._replace(nbr=mrf_kernel.band_list(adj.band))
        return adj
    if far_capacity is None:
        far_capacity = max(block, (3 * n) // 4)
    nb = n // block
    dev = nbr_idx.device
    out_e, in_e, w_e, near, live = _directed_edges(nbr_idx, nbr_w, block)
    col = in_e - (out_e // block - 1) * block
    w_near = torch.where(near & live, w_e, 0.0)
    col = torch.where(near, col, 0)
    band = torch.zeros(n * 3 * block, dtype=nbr_w.dtype, device=dev)
    band.index_add_(0, out_e * (3 * block) + col, w_near)
    band = band.reshape(nb, block, 3 * block)

    far_out, far_in, far_w, n_dropped = _far_edges(
        out_e, in_e, w_e, near, live, far_capacity)
    deg = band.sum(2).reshape(n)
    deg = deg.index_add(0, far_out, far_w)
    return BandedAdjacency(
        band=band, far_out=far_out, far_in=far_in, far_w=far_w,
        deg=deg[:, None], n_dropped=n_dropped,
    )


def _directed_edges(nbr_idx, nbr_w, block: int):
    """Both directions of every k-NN edge, each with 0.5 w: (out, in, w,
    near, live) over the 2 N k directed entries, the forward (i <- j)
    ones first in (i, k) order, then the reverse ones in the same order;
    near where the two blocks are adjacent."""
    n, k = nbr_idx.shape
    i_idx = torch.arange(n, dtype=torch.int64,
                         device=nbr_idx.device).repeat_interleave(k)
    j_idx = nbr_idx.reshape(-1).to(torch.int64)
    w_half = 0.5 * nbr_w.reshape(-1)
    out_e = torch.cat([i_idx, j_idx])
    in_e = torch.cat([j_idx, i_idx])
    w_e = torch.cat([w_half, w_half])
    near = (out_e // block - in_e // block).abs() <= 1
    return out_e, in_e, w_e, near, w_e > 0


def _far_edges(out_e, in_e, w_e, near, live, far_capacity: int):
    """The far list of `_directed_edges`: far live entries compacted to
    the front in their order (stable argsort, as labeling.py:382), cut
    at `far_capacity`, zero-padded; and the count cut off."""
    is_far = ~near & live
    order = torch.argsort((~is_far).to(torch.int32), stable=True)
    sel = order[:far_capacity]
    far_live = is_far[sel]
    far_out = torch.where(far_live, out_e[sel], 0)
    far_in = torch.where(far_live, in_e[sel], 0)
    far_w = torch.where(far_live, w_e[sel], 0.0)
    n_far = is_far.sum().to(torch.int32)
    return far_out, far_in, far_w, torch.clamp_min(n_far - far_capacity, 0)


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
    band_f, in_band = _forward_band(nbr_idx, nbr_w, block, 0)
    r_blk, l_blk = band_f[:, :, 2 * block:], band_f[:, :, :block]
    band = _symmetric_band(band_f, torch.roll(r_blk, 1, dims=0),
                           torch.roll(l_blk, -1, dims=0))
    return _far_free(band, 2 * (~in_band & (nbr_w > 0)).sum())


def _forward_band(nbr_idx, nbr_w, block: int, row0: int):
    """(band_f (nb, B, 3B), in_band (n, k)): the forward band of rows
    row0.. row0+n-1 of a windowed graph, 0.5 w of each row's own edges at
    its window column (global column (b-1)*B + c), and which edges lie in
    the row's window."""
    n, k = nbr_idx.shape
    dev = nbr_idx.device
    blk_row = (row0 + torch.arange(n, device=dev))[:, None] // block
    col = nbr_idx.to(torch.int64) - (blk_row - 1) * block  # (n, k)
    in_band = (col >= 0) & (col < 3 * block)
    w_f = torch.where(in_band, 0.5 * nbr_w, 0.0)
    col = torch.clamp(col, 0, 3 * block - 1)
    band_f = torch.zeros((n, 3 * block), dtype=nbr_w.dtype, device=dev)
    band_f.scatter_add_(1, col, w_f)
    return band_f.reshape(n // block, block, 3 * block), in_band


def _symmetric_band(band_f, r_prev, l_next):
    """band_f + its reverse half, [R_{b-1}^T, M_b^T, L_{b+1}^T] at block
    b, given each block's previous block's right third `r_prev` and its
    next block's left third `l_next` (nb, B, B)."""
    block = band_f.shape[1]
    m_blk = band_f[:, :, block:2 * block]
    return band_f + torch.cat([r_prev.transpose(1, 2), m_blk.transpose(1, 2),
                               l_next.transpose(1, 2)], dim=2)


def _far_free(band, n_dropped) -> BandedAdjacency:
    """A far-free band's adjacency: its degree, empty far arrays."""
    dev = band.device
    empty_i = torch.zeros((0,), dtype=torch.int64, device=dev)
    return BandedAdjacency(
        band=band.contiguous(), far_out=empty_i, far_in=empty_i,
        far_w=torch.zeros((0,), dtype=band.dtype, device=dev),
        deg=band.sum(2).reshape(-1)[:, None],
        n_dropped=n_dropped.to(torch.int32),
    )


class PointFar(NamedTuple):
    """The far edges of a 'pt' rank's own rows (`shard_adjacency`), in
    the whole far list's order: `out` the own row (local index), `w` the
    weight, `src` the column's slot in the gathered far columns. `send`
    (cols,): the own points that some rank's far edges read, padded with
    0 to the most any rank sends, so that one all_gather of (R, cols)
    carries every far column. `deg` (n_own, 1): the own points' degree,
    the far edges' weights included."""

    out: torch.Tensor
    src: torch.Tensor
    w: torch.Tensor
    send: torch.Tensor
    deg: torch.Tensor


class PointShard:
    """A rank's share of the point axis of a 'pt' mesh (parallel/mesh.py):
    the Morton-sorted points' contiguous run of blocks [lo, hi), N / pt
    points, and the collectives its labeling needs. Every (., N) array
    of the fit lives on the rank's own points; a sweep reads them through
    `window`, the own points with the previous and the next rank's edge
    block (mesh.halo_exchange), zeros past the ends. `adj` is the
    window's band (`build_window_adjacency`), its halo blocks' rows zero;
    on the exact graph `far` holds the own rows' far edges, whose columns
    a sweep gathers (`agree_t`), and None on a far-free band
    (`shard_adjacency`). `n_dropped` is the whole graph's count of far
    edges past the capacity."""

    def __init__(self, mesh, n: int, block: int):
        npt = mesh.shape["pt"]
        self.mesh, self.block = mesh, block
        self.n_own = n // npt
        self.lo = mesh.axis_index("pt") * self.n_own
        self.hi = self.lo + self.n_own
        self.adj = None
        self.far: PointFar | None = None
        self.n_dropped = None

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.psum(t, "pt")

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """t with n_own points along `dim` on every rank -> N points
        there, in Morton order."""
        return torch.cat(self.mesh.all_gather(t, "pt").unbind(0), dim=dim)

    def window(self, t: torch.Tensor) -> torch.Tensor:
        """(R, n_own) -> (R, n_own + 2B): the halo exchange."""
        prev, nxt = self.mesh.halo_exchange(t, "pt", self.block)
        return torch.cat([prev, t, nxt], dim=-1)

    def inner(self, t_win: torch.Tensor) -> torch.Tensor:
        """(..., n_own + 2B) -> the own points (..., n_own)."""
        return t_win[..., self.block:self.block + self.n_own]

    def agree_t(self, p_t: torch.Tensor) -> torch.Tensor:
        """The agreement of the own points, (R, n_own) -> (R, n_own): the
        window band's agree_t, its own points kept; on the exact graph
        plus the far edges' terms, added in the whole far list's order
        after one all_gather of the far columns."""
        out = self.inner(self.adj.agree_t(self.window(p_t)))
        if self.far is None:
            return out
        f = self.far
        cols = self.mesh.all_gather(p_t[:, f.send].contiguous(), "pt")
        cols = cols.transpose(0, 1).reshape(p_t.shape[0], -1)
        return out.index_add_(1, f.out, cols[:, f.src] * f.w[None, :])

    @property
    def deg(self) -> torch.Tensor:
        """The own points' symmetrized degree, (n_own, 1)."""
        if self.far is not None:
            return self.far.deg
        return self.adj.deg[self.block:self.block + self.n_own]


def build_window_adjacency(nbr_idx, nbr_w, shard: PointShard,
                           neighbour_list: bool = False) -> BandedAdjacency:
    """`_build_band_far_free` for a 'pt' rank: nbr_idx / nbr_w are the
    windowed graph's rows of its own points (global columns). The
    reverse half of block b's band reads the forward band of blocks b-1
    and b+1, so the ranks exchange their edge blocks' forward rows once
    (mesh.halo_exchange). Returns the band of the rank's window, a zero
    block on each side of its own blocks (rows whose sweep output
    is discarded), with the window's neighbour list when `neighbour_list`
    (a CUDA band). The own rows equal the whole band's: its entries
    are sums of {0, 0.5}, exact in any order. n_dropped counts the own
    rows only (the caller sums it over the axis)."""
    block = shard.block
    band_f, in_band = _forward_band(nbr_idx, nbr_w, block, shard.lo)
    prev, nxt = shard.mesh.halo_exchange(
        band_f.reshape(-1, 3 * block).T, "pt", block)
    r_blk, l_blk = band_f[:, :, 2 * block:], band_f[:, :, :block]
    band = _symmetric_band(
        band_f, torch.cat([prev.T[None, :, 2 * block:], r_blk[:-1]]),
        torch.cat([l_blk[1:], nxt.T[None, :, :block]]))
    zero = torch.zeros_like(band[:1])
    adj = _far_free(torch.cat([zero, band, zero]),
                    2 * (~in_band & (nbr_w > 0)).sum())
    if neighbour_list:
        adj = adj._replace(nbr=mrf_kernel.band_list(adj.band))
    return adj


def shard_adjacency(nbr_idx, nbr_w, shard: PointShard, windowed: bool,
                    neighbour_list: bool = False) -> BandedAdjacency:
    """A 'pt' rank's share of the fit's banded adjacency, set on `shard`
    (adj, far, n_dropped) from its own rows of the k-NN graph. The
    windowed graph: the far-free window band (`build_window_adjacency`),
    n_dropped summed over the axis. The exact graph: the same window
    band (its near blocks), and the far list of `build_banded_adjacency`
    built on the gathered graph, as the single fit builds it, so that
    which edges the capacity cuts and n_dropped are the single fit's;
    the rank keeps the far edges into its own rows and the slots of
    their columns in one all_gather a sweep (`PointShard.agree_t`).
    With `neighbour_list`, the window band carries its list wherever the
    rank's sweeps read no far edge."""
    if windowed:
        adj = build_window_adjacency(nbr_idx, nbr_w, shard, neighbour_list)
        shard.adj, shard.n_dropped = adj, shard.psum(adj.n_dropped)
        return adj
    adj = build_window_adjacency(nbr_idx, nbr_w, shard, neighbour_list=False)
    g_idx = shard.gather(nbr_idx.T).T
    g_w = shard.gather(nbr_w.T).T
    n, block = g_idx.shape[0], shard.block
    far_out, far_in, far_w, n_dropped = _far_edges(
        *_directed_edges(g_idx, g_w, block), max(block, (3 * n) // 4))
    shard.adj, shard.n_dropped = adj, n_dropped
    shard.far = _own_far(far_out, far_in, far_w, shard)
    if shard.far is None and neighbour_list:
        adj = shard.adj = adj._replace(nbr=mrf_kernel.band_list(adj.band))
    return adj


def _own_far(far_out, far_in, far_w, shard: PointShard) -> PointFar | None:
    """The own rows' entries of the whole far list (None when no edge is
    live): each rank sends the far columns it owns, `cols` a rank, the
    most any rank owns; column c's slot in the gathered (R, pt * cols)
    is owner * cols + its rank among the owner's far columns."""
    npt, n_own, lo = shard.mesh.shape["pt"], shard.n_own, shard.lo
    live = far_w > 0
    need = torch.zeros(npt * n_own, dtype=torch.bool, device=far_w.device)
    need[far_in[live]] = True
    need = need.reshape(npt, n_own)
    cols = int(need.sum(1).max())
    if cols == 0:
        return None
    slot = (torch.cumsum(need.to(torch.int64), 1) - 1
            + cols * torch.arange(npt, device=need.device)[:, None])
    mine = torch.nonzero(live & (far_out >= lo)
                         & (far_out < lo + n_own))[:, 0]
    send = torch.nonzero(need[shard.mesh.axis_index("pt")])[:, 0]
    send = torch.cat([send, send.new_zeros(cols - send.shape[0])])
    out, w = far_out[mine] - lo, far_w[mine]
    deg = shard.adj.deg[shard.block:shard.block + n_own, 0].index_add(
        0, out, w)
    return PointFar(out=out, src=slot.reshape(-1)[far_in[mine]], w=w,
                    send=send, deg=deg[:, None])


def _mrf_kernel_ok(adj: BandedAdjacency | None) -> bool:
    """A far-edge-free banded adjacency: the band the fused MRF sweeps
    (the kernels or their plain versions) run on."""
    return adj is not None and adj.far_w.shape[0] == 0


def _mrf_kernels_run(adj: BandedAdjacency | None) -> bool:
    """Whether the fused MRF kernels run: exactly where the adjacency
    carries its neighbour list (only a far-free band does)."""
    return adj is not None and adj.nbr is not None


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


def total_energy_t(labels, dct, nbr_idx, nbr_w, spatial_weight: float,
                   label_cost: float, active, adj=None, shard=None):
    """E(L) = data + lambda * Potts + beta * |used active labels|, the
    Potts term through the band's agreement operator or the gather
    path's (labeling.py:478). With a `shard` (PointShard), labels and
    dct are its own points' and the sums run over the 'pt' axis."""
    l = dct.shape[0]
    agree_fn, deg = _agree_and_deg_t(nbr_idx, nbr_w, adj, dct.dtype, shard)
    e_mrf = _energies_batch(labels[None], dct, agree_fn, deg,
                            spatial_weight, shard)[0]
    n_used = _onehot_t(labels, l, dct.dtype)[:l - 1].sum(1)
    if shard is not None:
        n_used = shard.psum(n_used)
    return (e_mrf + label_cost * ((n_used > 0) & (active > 0)).sum()
            ).to(dct.dtype)


# ---------------------------------------------------------------------------
# the gather path's agreement operator (no banded adjacency)
# ---------------------------------------------------------------------------

def _neighbor_agreement_t(p_t, nbr_idx, nbr_w):
    """Label-major symmetrized k-NN agreement (labeling.py:504): p_t is
    (L, N); returns (L, N) = 0.5 * (the direct gather over each point's
    own edges + the reverse scatter-add over the edges that point at
    it), the counterpart of the band's agree_t. The scatter is
    index_add_: on CUDA its atomic order moves the last bits of a float
    sum from run to run (0/1 one-hots sum exactly)."""
    idx = nbr_idx.long()
    direct = (p_t[:, idx] * nbr_w).sum(2)
    contrib = (p_t[:, :, None] * nbr_w).reshape(p_t.shape[0], -1)
    rev = torch.zeros_like(p_t).index_add_(1, idx.reshape(-1), contrib)
    return 0.5 * (direct + rev)


def _degree(nbr_idx, nbr_w, dtype):
    """Symmetrized degree (N, 1) under the same 0.5 * (direct + reverse)
    convention (labeling.py:520)."""
    n = nbr_idx.shape[0]
    direct = nbr_w.sum(1)
    rev = torch.zeros((n,), dtype=dtype, device=nbr_w.device).index_add_(
        0, nbr_idx.reshape(-1).long(), nbr_w.reshape(-1).to(dtype))
    return (0.5 * (direct + rev))[:, None]


def _agree_and_deg_t(nbr_idx, nbr_w, adj: BandedAdjacency | None, dtype,
                     shard: PointShard | None = None):
    """The agreement operator (L, N) -> (L, N) and the (1, N) degree: the
    band's when an adjacency was built, the gather path's otherwise
    (labeling.py:543); a 'pt' rank's own points' through its window
    (PointShard.agree_t) with a `shard`."""
    if shard is not None:
        return shard.agree_t, shard.deg.T
    if adj is not None:
        return adj.agree_t, adj.deg.T
    return (lambda p_t: _neighbor_agreement_t(p_t, nbr_idx, nbr_w),
            _degree(nbr_idx, nbr_w, dtype).T)


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
                 q_init=None, adj=None, shard: PointShard | None = None):
    """Annealed mean-field for the Potts MRF, label-major (L, N):
    q <- softmax_l(-(D + lambda (deg - agree(q))) / T) per sweep, over the
    band when `adj` is given, over the k-NN graph's gather otherwise. The
    JAX lax.scan over temperatures (labeling.py:640) is a Python loop.
    Over a far-free band all sweeps run in the fused kernel
    (mrf_kernel.mean_field_fused, one call) where the adjacency carries
    its neighbour list, else in its plain version. With a `shard`, dct
    and q are a 'pt' rank's own points and every sweep exchanges the
    halo: on a far-free band the kernel (where shard.adj carries the
    list) or its plain version a call a sweep
    (mrf_kernel.mean_field_windowed), on the exact graph's band the plain
    sweeps, each reading the far columns too (PointShard.agree_t)."""
    q = torch.softmax(-dct, dim=0) if q_init is None else q_init
    temps = _mf_temps(iterations, temp_start, temp_end, dct.dtype,
                      dct.device)
    if shard is not None and shard.far is None:
        base = dct + spatial_weight * shard.deg.T
        return mrf_kernel.mean_field_windowed(
            q.contiguous(), base.contiguous(), shard.adj.band, 1.0 / temps,
            spatial_weight, shard.window, nbr=shard.adj.nbr)
    if shard is None and _mrf_kernel_ok(adj):
        base = dct + spatial_weight * adj.deg.T  # (L, N)
        if adj.nbr is None:
            return mrf_kernel.mean_field_fused_reference(
                q, base, adj.band, 1.0 / temps, spatial_weight)
        return mrf_kernel.mean_field_fused(
            q.contiguous(), base.contiguous(), adj.band, 1.0 / temps,
            spatial_weight, nbr=adj.nbr,
        )
    agree_fn, deg = _agree_and_deg_t(nbr_idx, nbr_w, adj, dct.dtype, shard)
    for i in range(temps.shape[0]):
        pair = spatial_weight * (deg - agree_fn(q))
        q = torch.softmax(-(dct + pair) / temps[i], dim=0)
    return q


def pearl_relax_fused(x1, x2, valid, Hs, active, thr, outlier_cost: float,
                      spatial_weight: float, iterations: int,
                      temp_start: float, temp_end: float, q_init,
                      adj: BandedAdjacency, kind: str = "symmetric"):
    """residual_matrix -> data_costs_t -> mean_field_t as one fused call
    (labeling.py:652) on the fit's own tensors and the band's degree:
    the CUDA kernel (mrf_kernel.mean_field_fused_front) where the
    adjacency carries its neighbour list, else its plain version.
    Homography transfer / symmetric kinds and a far-free band only.
    Returns (q, dct, r) for the rest of the PEARL iteration."""
    temps = _mf_temps(iterations, temp_start, temp_end, torch.float32,
                      x1.device)
    front = (mrf_kernel.mean_field_fused_front if adj.nbr is not None
             else mrf_kernel.mean_field_fused_front_reference)
    return front(q_init.to(torch.float32).contiguous(), x1, x2, valid,
                 adj.deg, Hs, active, adj.band, 1.0 / temps, thr,
                 spatial_weight, outlier_cost, kind=kind, nbr=adj.nbr)


def _energies_batch(labels, dct, agree_fn, deg, spatial_weight,
                    shard: PointShard | None = None):
    """(S, N) labelings -> (S,) data + lambda * Potts energies, no
    label-cost term (labeling.py:792). Potts is 0.5 * sum_i (deg_i -
    agree(onehot)[l_i, i]) through either agreement operator: the
    directed-edge sum of w * [l_p != l_q] / 2 (labeling.py:761). With a
    `shard`, each rank's partial sums are summed over the 'pt' axis.
    The sums over N run in float64 (the sums over L are exact: one term
    is nonzero), so that the ranks' partial sums agree with one sum and
    pick the same start; float64 energies."""
    s, n = labels.shape
    l = dct.shape[0]
    onehot = _onehot_t(labels, l, dct.dtype)  # (S, L, N)
    e_data = (onehot * dct[None]).sum(1).double().sum(1)
    agree = agree_fn(onehot.reshape(s * l, n)).reshape(s, l, n)
    own = (onehot * agree).sum(1)
    e_potts = 0.5 * (deg - own).double().sum(1)
    e = e_data + spatial_weight * e_potts
    return e if shard is None else shard.psum(e)


def _icm_batch(starts, dct, spatial_weight: float, iterations: int,
               adj: BandedAdjacency | None, nbr_idx=None, nbr_w=None,
               shard: PointShard | None = None):
    """Red-black ICM from S start labelings at once, (S, N) -> (S, N),
    over the band when `adj` is given, over the k-NN graph (nbr_idx,
    nbr_w) otherwise: each half-sweep moves the points of one index
    parity to their cheapest label (the first minimum on ties) when it
    beats the current one by more than 1e-6, then the constant-labeling
    escape adopts the best constant labeling if it has lower energy
    (labeling.py:702-753). The fori_loop is a Python loop; over a
    far-free band the half-sweeps run in the fused kernel
    (mrf_kernel.icm_fused, one call) where the adjacency carries its
    neighbour list, else in its plain version. With a `shard` (a 'pt'
    rank's own points), on a far-free band the kernel (where shard.adj
    carries the list) or its plain version a call a half-sweep, the halo
    exchanged before each (mrf_kernel.icm_windowed), on the exact graph's
    band the plain half-sweeps through PointShard.agree_t (one gather of
    the far columns each); the energies are summed over the axis."""
    agree_fn, deg = _agree_and_deg_t(nbr_idx, nbr_w, adj, dct.dtype, shard)
    base = dct + spatial_weight * deg  # (L, N)
    if shard is not None and shard.far is None:
        labels = mrf_kernel.icm_windowed(
            starts.to(torch.int32).contiguous(), base.contiguous(),
            shard.adj.band, iterations, spatial_weight, shard.window,
            nbr=shard.adj.nbr).to(starts.dtype)
    elif shard is None and _mrf_kernel_ok(adj) and adj.nbr is None:
        labels = mrf_kernel.icm_fused_reference(
            starts.to(torch.int32), base, adj.band, iterations,
            spatial_weight).to(starts.dtype)
    elif shard is None and _mrf_kernel_ok(adj):
        labels = mrf_kernel.icm_fused(
            starts.to(torch.int32).contiguous(), base.contiguous(),
            adj.band, iterations, spatial_weight, nbr=adj.nbr,
        ).to(starts.dtype)
    else:
        labels = _icm_sweeps(starts, dct, spatial_weight, iterations,
                             agree_fn, deg)
    e_cur = _energies_batch(labels, dct, agree_fn, deg, spatial_weight,
                            shard)
    e_const = dct.double().sum(1)
    if shard is not None:
        e_const = shard.psum(e_const)
    return torch.where((e_const.min() < e_cur)[:, None],
                       torch.argmin(e_const).to(labels.dtype), labels)


def _icm_sweeps(starts, dct, spatial_weight: float, iterations: int,
                agree_fn, deg):
    """The red-black half-sweeps of `_icm_batch`, plain PyTorch."""
    s, n = starts.shape
    l = dct.shape[0]
    parity = torch.arange(n, device=starts.device) % 2

    def half(labels, par):
        onehot = _onehot_t(labels, l, dct.dtype)  # (S, L, N)
        agree = agree_fn(onehot.reshape(s * l, n)).reshape(s, l, n)
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
                    icm_iterations: int, adj=None,
                    shard: PointShard | None = None):
    """ICM from several start labelings, polished together
    (`_icm_batch`: the fused kernel where the adjacency carries its
    neighbour list); returns the one of lowest data + Potts energy, the
    first on ties, without a label-cost term (labeling.py:923-960). With
    a `shard`, on a 'pt' rank's own points, the energies over the axis."""
    polished = _icm_batch(torch.stack(starts), dct, spatial_weight,
                          icm_iterations, adj, nbr_idx=nbr_idx, nbr_w=nbr_w,
                          shard=shard)
    agree_fn, deg = _agree_and_deg_t(nbr_idx, nbr_w, adj, dct.dtype, shard)
    energies = _energies_batch(polished, dct, agree_fn, deg, spatial_weight,
                               shard)
    return polished.index_select(0, torch.argmin(energies).view(1))[0]
