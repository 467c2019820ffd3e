"""Fused PEARL relaxation sweeps over the banded adjacency: the CUDA
mean-field, fused-front mean-field and red-black ICM kernels, the
neighbour-list build they read, and their plain PyTorch versions.

Replaces ``multih_tpu/ops/kernels/mrf_kernel.py`` (``_mf_kernel`` via
``mean_field_fused``, ``_mf_front_kernel`` via ``mean_field_fused_front``,
``_icm_kernel`` via ``icm_fused``). All need a
far-edge-free band (the windowed k-NN graph's): per Morton block b the
agreement is the (L, 3B) window of the state times band[b]^T, and block
0's left third and block nb-1's right third read zeros (labels -1).

The kernels (``csrc/mrf_kernel.cu``) read the band through its
neighbour list (`band_list`: per row, the count and the (global column,
weight) pairs of its non-zeros in column order, in a fixed capacity of
3B slots), built once per fit beside the band. Each wrapper call is one
cooperative launch that runs every sweep (every half-sweep of every
start for ICM), a grid-wide sync the barrier between them, the state in
device memory. The fused front is its front and every sweep in one
launch too, the front before the first grid barrier. In every sweep
one warp updates a point, one label a lane (two for L > 32).

The plain versions repeat the kernels' arithmetic order (they are the
parity oracle on the card and the CPU tests' stand-in for the Pallas
kernels): mean-field z = -(base - sw*agree) * inv_temp[s], minus its max
over labels, exp, divided by the sum; ICM cost = base - sw*agree, a
compare-select argmin with strict < (first minimum wins), the current
label's cost by one-hot sum, and a move only on the half-sweep's parity
when better by more than 1e-6. In both, base = dct + sw*deg^T is built
by the caller.

The fused front computes the (K, N) homography residuals, the data
costs and base from the fit's own tensors (x1, x2, valid, the band's
degree, Hs, active) before the sweeps of the same launch
(csrc/mrf_kernel.cu, mf_front_grid, whose sweeps are K4's code); its
plain version is geometry.residual_matrix -> labeling.data_costs_t ->
the plain sweeps.

Tolerances against the plain versions: the neighbour list bit-exact;
mean-field q within 1e-5 max-abs (the agreement sums in list order, the
plain bmm in its own); ICM labels exact (the band values {0, 0.5, 1}
make every agreement sum exact, and the kernel rounds sw*agree and the
subtraction separately, as PyTorch does); the front's r to rtol 1e-3 /
atol 1e-4 below 1e6 px^2 and min(r/thr, 8) to atol 1e-4 everywhere (the
elementwise residual against the plain matmul; past 1e6 px^2 w nears
zero, float32 cancellation sets r's digits and the cost is saturated),
its dct equal to data_costs_t of its own r, its q equal to K4's on its
own base dct + sw*deg^T bit for bit (the same sweep code; so within 1e-5
of the plain sweeps there) and within 1e-4 of the plain version (r's
last bits, where px - u cancels, reach q through 1/T up to 4).

The wrappers take CUDA tensors only and raise on anything else; the
callers (labeling.build_banded_adjacency, labeling.mean_field_t,
labeling._icm_batch, labeling.pearl_relax_fused) choose the plain
versions for CPU tensors.

On a 'pt' mesh a rank holds its own Morton blocks only, and a cooperative
launch of every sweep cannot wait on a neighbour's halo. So
`mean_field_windowed` and `icm_windowed` launch K4 once a sweep and K5
once a half-sweep (`half_sweeps=1`, `parity0` alternating) on the rank's
window, its own blocks plus one halo block a side, the halo exchanged
before each launch; the band reaches one block, so the own blocks come
out bit-equal to the unsharded launch. Their plain form calls the plain
versions the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multih_tpu_torch.ops import geometry
from multih_tpu_torch.ops.kernels import _build

MAX_LABELS = 64  # one or two labels a lane of a warp


def _band_window(state: torch.Tensor, nb: int, block: int, fill):
    """(R, N) -> (R, nb, 3B): each block's window of the state, with
    `fill` in the halos (no wrap)."""
    r = state.shape[0]
    pad = torch.full((r, block), fill, dtype=state.dtype,
                     device=state.device)
    padded = torch.cat([pad, state, pad], dim=1)  # (R, N + 2B)
    return padded.unfold(1, 3 * block, block)  # (R, nb, 3B)


def _agree(win: torch.Tensor, band: torch.Tensor) -> torch.Tensor:
    """(R, nb, 3B) windows x band (nb, B, 3B) -> (R, N) agreements."""
    r = win.shape[0]
    out = torch.bmm(win.transpose(0, 1), band.transpose(1, 2))  # (nb, R, B)
    return out.transpose(0, 1).reshape(r, -1)


def mean_field_fused_reference(q0_t, base_t, band, inv_temps,
                               spatial_weight: float) -> torch.Tensor:
    """Plain version of `mean_field_fused`, the kernel's arithmetic."""
    nb, block, _ = band.shape
    q = q0_t
    for s in range(inv_temps.shape[0]):
        agree = _agree(_band_window(q, nb, block, 0.0), band)
        z = -(base_t - spatial_weight * agree) * inv_temps[s]
        z = z - z.amax(0, keepdim=True)
        e = torch.exp(z)
        q = e / e.sum(0, keepdim=True)
    return q


def icm_fused_reference(labels0, base_t, band, iterations: int,
                        spatial_weight: float, half_sweeps: int | None = None,
                        parity0: int = 0) -> torch.Tensor:
    """Plain version of `icm_fused`, the kernel's arithmetic."""
    nb, block, _ = band.shape
    ns, n = labels0.shape
    l = base_t.shape[0]
    ids = torch.arange(l, dtype=labels0.dtype, device=labels0.device)
    parity = torch.arange(n, device=labels0.device) % 2
    labels = labels0
    halves = 2 * iterations if half_sweeps is None else half_sweeps
    for h in range(parity0, parity0 + halves):
        win = _band_window(labels, nb, block, -1)  # (S, nb, 3B)
        oh = (win[:, None] == ids[None, :, None, None]).to(base_t.dtype)
        agree = _agree(oh.reshape(ns * l, nb, 3 * block), band)
        cost = base_t[None] - spatial_weight * agree.reshape(ns, l, n)
        new_c = cost[:, 0]
        new = torch.zeros_like(labels)
        for lab in range(1, l):
            take = cost[:, lab] < new_c
            new_c = torch.where(take, cost[:, lab], new_c)
            new = torch.where(take, lab, new)
        cur_oh = (labels[:, None, :] == ids[None, :, None]).to(cost.dtype)
        cur_c = (cur_oh * cost).sum(1)
        move = (new_c < cur_c - 1e-6) & (parity[None, :] == h % 2)
        labels = torch.where(move, new, labels)
    return labels


class NeighbourList(NamedTuple):
    """A far-free band's rows as lists: row i's cnt[i] non-zeros with an
    in-range column, in column order, at cols[i, :cnt[i]] (global point
    indices) and ws[i, :cnt[i]] (their weights); the slots past cnt[i]
    hold 0. Capacity 3B a row, so nothing sizes it on the host."""

    cols: torch.Tensor  # (N, 3B) int32
    ws: torch.Tensor  # (N, 3B) float32
    cnt: torch.Tensor  # (N,) int32


def band_list_reference(band: torch.Tensor) -> NeighbourList:
    """Plain version of `band_list`."""
    nb, block, bb = band.shape
    n = nb * block
    dev = band.device
    rows = band.reshape(n, bb)
    g = ((torch.arange(n, device=dev) // block - 1)[:, None] * block
         + torch.arange(bb, device=dev)[None, :])
    keep = (rows != 0) & (g >= 0) & (g < n)
    cnt = keep.sum(1)
    # kept entries first, in column order
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    used = torch.arange(bb, device=dev)[None, :] < cnt[:, None]
    cols = torch.where(used, torch.gather(g, 1, order), 0)
    ws = torch.where(used, torch.gather(rows, 1, order), 0.0)
    return NeighbourList(cols.to(torch.int32), ws.contiguous(),
                         cnt.to(torch.int32))


def band_list(band: torch.Tensor) -> NeighbourList:
    """The neighbour list of a far-free (nb, B, 3B) float32 band, one
    launch (a warp a row, ballot compaction). CUDA tensors only."""
    _build.require_cuda(band)
    nb, block, bb = band.shape
    if bb != 3 * block:
        raise ValueError(f"band {tuple(band.shape)} is not (nb, B, 3B)")
    n = nb * block
    cols = torch.empty((n, bb), dtype=torch.int32, device=band.device)
    ws = torch.empty((n, bb), dtype=torch.float32, device=band.device)
    cnt = torch.empty((n,), dtype=torch.int32, device=band.device)
    rc = _build.load().multih_band_list(
        band.data_ptr(), nb, block, cols.data_ptr(), ws.data_ptr(),
        cnt.data_ptr(), _build.stream_handle(band))
    _build.check(rc, "band_list")
    band_list.launches += 1
    return NeighbourList(cols, ws, cnt)


band_list.launches = 0

def _check_band(band: torch.Tensor, n: int, rows: int):
    nb, block, bb = band.shape
    if bb != 3 * block or nb * block != n:
        raise ValueError(f"band {tuple(band.shape)} does not fit N={n}")
    if rows > MAX_LABELS:
        raise ValueError(f"{rows} labels > {MAX_LABELS}")


def _neighbours(band: torch.Tensor, nbr: NeighbourList | None):
    """The caller's list, checked against the band, or the band's, built
    now (one more launch)."""
    if nbr is None:
        return band_list(band)
    n, bb = band.shape[0] * band.shape[1], band.shape[2]
    _build.require_cuda(nbr.cols, nbr.cnt, dtype=torch.int32)
    _build.require_cuda(nbr.ws)
    if (nbr.cols.shape != (n, bb) or nbr.ws.shape != (n, bb)
            or nbr.cnt.shape != (n,)):
        raise ValueError(f"neighbour list {tuple(nbr.cols.shape)} does not "
                         f"fit band {tuple(band.shape)}")
    return nbr


def _scratch(l: int, n: int, like: torch.Tensor) -> torch.Tensor:
    """Mean-field's point-major base and two state buffers."""
    return torch.empty((3 * n * (l | 1),), dtype=like.dtype,
                       device=like.device)


def mean_field_fused(q0_t: torch.Tensor, base_t: torch.Tensor,
                     band: torch.Tensor, inv_temps: torch.Tensor,
                     spatial_weight: float,
                     nbr: NeighbourList | None = None) -> torch.Tensor:
    """All annealed mean-field sweeps in one launch.

    q0_t, base_t: (L, N) float32 label-major (base = dct + sw*deg^T);
    band: (nb, B, 3B) float32, far-free; inv_temps: (S,) float32; nbr:
    the band's `band_list` (built here when None). Returns the (L, N)
    marginals after S sweeps. CUDA tensors only."""
    _build.require_cuda(q0_t, base_t, band, inv_temps)
    l, n = q0_t.shape
    if base_t.shape != q0_t.shape or inv_temps.dim() != 1:
        raise ValueError(f"q0 {tuple(q0_t.shape)}, base "
                         f"{tuple(base_t.shape)}, inv_temps "
                         f"{tuple(inv_temps.shape)}")
    _check_band(band, n, l)
    n_sweeps = inv_temps.shape[0]
    if n_sweeps == 0:
        return q0_t.clone()
    nbr = _neighbours(band, nbr)
    out = torch.empty_like(q0_t)
    tmp = _scratch(l, n, out)
    rc = _build.load().multih_mean_field(
        q0_t.data_ptr(), base_t.data_ptr(), nbr.cols.data_ptr(),
        nbr.ws.data_ptr(), nbr.cnt.data_ptr(), band.shape[2],
        inv_temps.data_ptr(), n_sweeps, l, n, float(spatial_weight),
        out.data_ptr(), tmp.data_ptr(), _build.stream_handle(q0_t),
    )
    _build.check(rc, "mean_field_fused")
    mean_field_fused.launches += 1
    return out


mean_field_fused.launches = 0


FRONT_KINDS = ("symmetric", "transfer")


def mean_field_fused_front_reference(q0_t, x1, x2, valid, deg, Hs, active,
                                     band, inv_temps, thr,
                                     spatial_weight: float,
                                     outlier_cost: float,
                                     kind: str = "symmetric", nbr=None):
    """Plain version of `mean_field_fused_front`:
    geometry.residual_matrix -> labeling.data_costs_t -> the plain sweeps
    of `mean_field_fused_reference` on base = dct + sw*deg^T, on the same
    inputs (it reads the band; `nbr`, the kernel's view of it, is
    accepted so the two are called alike)."""
    from multih_tpu_torch.models import labeling  # labeling imports us

    r = geometry.residual_matrix(Hs, x1, x2, kind)
    dct = labeling.data_costs_t(r, valid, thr, outlier_cost, active)
    base = dct + spatial_weight * deg.reshape(1, -1)
    q = mean_field_fused_reference(q0_t, base, band, inv_temps,
                                   spatial_weight)
    return q, dct, r


def mean_field_fused_front(q0_t: torch.Tensor, x1: torch.Tensor,
                           x2: torch.Tensor, valid: torch.Tensor,
                           deg: torch.Tensor, Hs: torch.Tensor,
                           active: torch.Tensor, band: torch.Tensor,
                           inv_temps: torch.Tensor, thr,
                           spatial_weight: float, outlier_cost: float,
                           kind: str = "symmetric",
                           nbr: NeighbourList | None = None):
    """`mean_field_fused` with the residual and data-cost front fused in
    (homography "symmetric" / "transfer" kinds): the front and every
    sweep in one launch, on the fit's own tensors.

    q0_t: (L, N) float32; x1, x2: (N, 2) float32; valid: (N,) float32;
    deg: the band's (N, 1) or (N,) degree; Hs: (L-1, 3, 3) float32;
    active: (L-1,) float32 (the points' and planes' tensors are read by
    their strides); band: (nb, B, 3B) float32, far-free; inv_temps: (S,)
    float32; thr: the squared inlier threshold, a one-element float32
    CUDA tensor (read on the card, never synchronised; a number or
    another type is made one); nbr: the band's `band_list` (built here
    when None). Returns (q (L, N), dct (L, N), r (L-1, N)); with S = 0, q
    is a copy of q0. CUDA tensors only."""
    _build.require_cuda(q0_t, band, inv_temps)
    _build.require_cuda(x1, x2, valid, deg, Hs, active, contiguous=False)
    l, n = q0_t.shape
    k = l - 1
    if kind not in FRONT_KINDS:
        raise ValueError(f"fused front kind {kind!r} not in {FRONT_KINDS}")
    if (x1.shape != (n, 2) or x2.shape != (n, 2) or valid.shape != (n,)
            or deg.shape not in ((n, 1), (n,)) or Hs.shape != (k, 3, 3)
            or active.shape != (k,) or inv_temps.dim() != 1):
        raise ValueError(f"q0 {tuple(q0_t.shape)}, x1 {tuple(x1.shape)}, "
                         f"x2 {tuple(x2.shape)}, valid {tuple(valid.shape)},"
                         f" deg {tuple(deg.shape)}, Hs {tuple(Hs.shape)}, "
                         f"active {tuple(active.shape)}, inv_temps "
                         f"{tuple(inv_temps.shape)}")
    _check_band(band, n, l)
    if not torch.is_tensor(thr):  # filled on the card: no host copy
        thr = torch.full((), float(thr), dtype=torch.float32,
                         device=q0_t.device)
    elif not (thr.numel() == 1 and thr.dtype == torch.float32
              and thr.device == q0_t.device):
        thr = torch.as_tensor(thr, dtype=torch.float32, device=q0_t.device)
    ins = (x1, x2, valid, deg, Hs, active, band, inv_temps, thr)
    if any(t.device != q0_t.device for t in ins):
        raise ValueError("mean_field_fused_front: inputs on different "
                         "devices")
    nbr = _neighbours(band, nbr)
    n_sweeps = inv_temps.shape[0]
    out = torch.empty_like(q0_t)
    dct = torch.empty_like(q0_t)
    r = torch.empty((k, n), dtype=q0_t.dtype, device=q0_t.device)
    tmp = _scratch(l, n, out)
    rc = _build.load().multih_mean_field_front(
        q0_t.data_ptr(), x1.data_ptr(), *x1.stride(), x2.data_ptr(),
        *x2.stride(), valid.data_ptr(), valid.stride(0), deg.data_ptr(),
        deg.stride(0), Hs.data_ptr(), *Hs.stride(), active.data_ptr(),
        active.stride(0), thr.data_ptr(), nbr.cols.data_ptr(),
        nbr.ws.data_ptr(), nbr.cnt.data_ptr(), band.shape[2],
        inv_temps.data_ptr(), n_sweeps, l, n, float(spatial_weight),
        float(outlier_cost), int(kind == "symmetric"), out.data_ptr(),
        dct.data_ptr(), r.data_ptr(), tmp.data_ptr(),
        _build.stream_handle(q0_t),
    )
    _build.check(rc, "mean_field_fused_front")
    mean_field_fused_front.launches += 1
    return out, dct, r


mean_field_fused_front.launches = 0


def icm_fused(labels0: torch.Tensor, base_t: torch.Tensor,
              band: torch.Tensor, iterations: int,
              spatial_weight: float,
              nbr: NeighbourList | None = None,
              half_sweeps: int | None = None,
              parity0: int = 0) -> torch.Tensor:
    """All 2*iterations red-black ICM half-sweeps of S starts in one
    launch, parity 0 first; with `half_sweeps`, that many, the first on
    parity `parity0` (a 'pt' rank's one half-sweep a launch).

    labels0: (S, N) int32; base_t: (L, N) float32 (dct + sw*deg^T);
    band: (nb, B, 3B) float32, far-free; nbr: the band's `band_list`
    (built here when None). Returns (S, N) int32. The constant-labeling
    escape stays with the caller. CUDA tensors only."""
    _build.require_cuda(labels0, dtype=torch.int32)
    _build.require_cuda(base_t, band)
    ns, n = labels0.shape
    l = base_t.shape[0]
    if base_t.shape[1] != n:
        raise ValueError(f"labels {tuple(labels0.shape)}, base "
                         f"{tuple(base_t.shape)}")
    _check_band(band, n, l)
    halves = 2 * iterations if half_sweeps is None else half_sweeps
    if halves <= 0:
        return labels0.clone()
    nbr = _neighbours(band, nbr)
    out = torch.empty_like(labels0)
    tmp = torch.empty((2 * ns * n,), dtype=torch.int32,
                      device=labels0.device)  # the labels, double-buffered
    rc = _build.load().multih_icm(
        labels0.data_ptr(), base_t.data_ptr(), nbr.cols.data_ptr(),
        nbr.ws.data_ptr(), nbr.cnt.data_ptr(), band.shape[2], halves,
        parity0 & 1, ns, l, n, float(spatial_weight), out.data_ptr(),
        tmp.data_ptr(), _build.stream_handle(labels0),
    )
    _build.check(rc, "icm_fused")
    icm_fused.launches += 1
    return out


icm_fused.launches = 0


# ---------------------------------------------------------------------------
# a 'pt' rank's sweeps: its own blocks and a one-block halo on each side
# ---------------------------------------------------------------------------

def _pad_window(t: torch.Tensor, block: int) -> torch.Tensor:
    """(R, n_own) -> (R, n_own + 2B), a zero block on each side."""
    z = torch.zeros((t.shape[0], block), dtype=t.dtype, device=t.device)
    return torch.cat([z, t, z], dim=1)


def mean_field_windowed(q_t, base_t, band, inv_temps, spatial_weight: float,
                        window, nbr: NeighbourList | None = None,
                        use_kernel: bool = True) -> torch.Tensor:
    """The annealed mean-field sweeps of a rank's own rows (L, n_own) on
    a 'pt' mesh: each sweep one `mean_field_fused` launch (with
    `use_kernel`, else its plain version) on the rank's window, its own
    blocks plus one halo block on each side, `window(q)` exchanging the
    halo; only the own blocks' output is kept. band: the window's (n_own
    / B + 2, B, 3B) band, its halo blocks' rows zero; nbr its list. The
    band reaches one block, so the own blocks equal the unsharded
    launch's bit for bit (the halo rows' output is discarded)."""
    block = band.shape[1]
    base_w = _pad_window(base_t, block).contiguous()
    own = slice(block, block + q_t.shape[1])
    q = q_t
    for s in range(inv_temps.shape[0]):
        q_w = window(q).contiguous()
        if use_kernel:
            q_w = mean_field_fused(q_w, base_w, band, inv_temps[s:s + 1],
                                   spatial_weight, nbr=nbr)
        else:
            q_w = mean_field_fused_reference(q_w, base_w, band,
                                             inv_temps[s:s + 1],
                                             spatial_weight)
        q = q_w[:, own]
    return q


def icm_windowed(labels0, base_t, band, iterations: int,
                 spatial_weight: float, window,
                 nbr: NeighbourList | None = None,
                 use_kernel: bool = True) -> torch.Tensor:
    """The 2*iterations red-black ICM half-sweeps of a rank's own rows
    (S, n_own) on a 'pt' mesh: one `icm_fused` half-sweep launch (with
    `use_kernel`, else its plain version) a half-sweep on the rank's
    window, parity 0 first, `window(labels)` exchanging the halo before
    each; as `mean_field_windowed`, the own blocks equal the unsharded
    launch's. The window starts at a multiple of B (even), so a window
    index has its global index's parity."""
    block = band.shape[1]
    base_w = _pad_window(base_t, block).contiguous()
    own = slice(block, block + labels0.shape[1])
    labels = labels0
    for h in range(2 * iterations):
        lab_w = window(labels).contiguous()
        if use_kernel:
            lab_w = icm_fused(lab_w, base_w, band, 0, spatial_weight,
                              nbr=nbr, half_sweeps=1, parity0=h % 2)
        else:
            lab_w = icm_fused_reference(lab_w, base_w, band, 0,
                                        spatial_weight, half_sweeps=1,
                                        parity0=h % 2)
        labels = lab_w[:, own]
    return labels
