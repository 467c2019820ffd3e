"""Homography geometry in PyTorch: normalization, minimal DLT solves,
residuals, the moment-formulated batched refit and small eigensolvers.

Counterpart of ``multih_tpu/ops/geometry.py`` (homography subset). Every
function is batch-first over leading dimensions where the JAX version is
vmapped, and keeps the JAX version's float32 operation order so the two
agree to rounding. Matrix products run in full fp32: the port disables
TF32 (``multih_tpu_torch.models.pipeline``), the counterpart of the JAX
package's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_EPS = 1e-12
_SQRT2 = math.sqrt(2.0)


# ---------------------------------------------------------------------------
# homogeneous helpers
# ---------------------------------------------------------------------------

def to_homogeneous(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) -> (..., 3) with unit w."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _signed_clamp(w: torch.Tensor) -> torch.Tensor:
    """|w| < EPS -> +-EPS with w's sign (points at infinity map far away
    instead of to NaN)."""
    return torch.where(w.abs() < _EPS,
                       torch.where(w < 0, -_EPS, _EPS).to(w.dtype), w)


def from_homogeneous(xh: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 2), guarding w ~ 0."""
    return xh[..., :2] / _signed_clamp(xh[..., 2:])


def adjugate_3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate of (..., 3, 3): the scale-free inverse."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    adj = torch.stack(
        [
            e * i - f * h, c * h - b * i, b * f - c * e,
            f * g - d * i, a * i - c * g, c * d - a * f,
            d * h - e * g, b * g - a * h, a * e - b * d,
        ],
        dim=-1,
    )
    return adj.reshape(*m.shape[:-2], 3, 3)


def _similarity(s, cx, cy):
    """Batched similarity [[s, 0, -s cx], [0, s, -s cy], [0, 0, 1]] from
    (...,) tensors."""
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * cx], dim=-1),
        torch.stack([zero, s, -s * cy], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def _similarity_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a batched similarity (geometry._denormalize_h's
    T2_inv): [[1/s, 0, -T02/s], [0, 1/s, -T12/s], [0, 0, 1]]."""
    s = T[..., 0, 0]
    inv_s = 1.0 / s
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    return torch.stack([
        torch.stack([inv_s, zero, -T[..., 0, 2] / s], dim=-1),
        torch.stack([zero, inv_s, -T[..., 1, 2] / s], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


# ---------------------------------------------------------------------------
# Hartley normalization and DLT rows
# ---------------------------------------------------------------------------

def hartley_normalize(pts: torch.Tensor, weights: torch.Tensor | None = None):
    """Similarity T with weighted centroid -> 0, RMS radius -> sqrt(2).

    pts: (..., N, 2); weights: optional (..., N). Returns (pts_n, T) with
    T of shape (..., 3, 3)."""
    if weights is None:
        weights = torch.ones(pts.shape[:-1], dtype=pts.dtype,
                             device=pts.device)
    wsum = torch.clamp_min(weights.sum(-1), _EPS)
    mean = (pts * weights[..., None]).sum(-2) / wsum[..., None]
    centered = pts - mean[..., None, :]
    rms = torch.sqrt(torch.clamp_min(
        ((centered ** 2).sum(-1) * weights).sum(-1) / wsum, _EPS))
    s = torch.full_like(rms, _SQRT2) / rms
    T = _similarity(s, mean[..., 0], mean[..., 1])
    return centered * s[..., None, None], T


def dlt_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) x2 -> (..., N, 2, 9) DLT constraint rows (see
    multih_tpu.ops.geometry.dlt_rows)."""
    x, y = x1[..., 0], x1[..., 1]
    u, v = x2[..., 0], x2[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    row_x = torch.stack(
        [zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1
    )
    row_y = torch.stack(
        [x, y, one, zero, zero, zero, -u * x, -u * y, -u], dim=-1
    )
    return torch.stack([row_x, row_y], dim=-2)


def dlt_normal_matrix(x1, x2, weights=None):
    """A^T A (..., 9, 9) of the (weighted) DLT system."""
    rows = dlt_rows(x1, x2)  # (..., N, 2, 9)
    lhs = rows if weights is None else rows * weights[..., None, None]
    return torch.einsum("...nki,...nkj->...ij", lhs, rows)


# ---------------------------------------------------------------------------
# smallest eigenvector of a 9x9 SPD matrix
# ---------------------------------------------------------------------------

def jacobi_eigh_small(a: torch.Tensor, sweeps: int = 6):
    """Cyclic Jacobi eigendecomposition (arctan2 rotations, applied
    unconditionally) of (..., n, n) symmetric matrices. Returns
    (diag (..., n), V (..., n, n)), columns of V unsorted."""
    n = a.shape[-1]
    a = a.clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand_as(a).clone()
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app, aqq, apq = a[..., p, p], a[..., q, q], a[..., p, q]
                theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
                c = torch.cos(theta)[..., None]
                s = torch.sin(theta)[..., None]
                row_p = c * a[..., p, :] - s * a[..., q, :]
                row_q = s * a[..., p, :] + c * a[..., q, :]
                a[..., p, :] = row_p
                a[..., q, :] = row_q
                col_p = c * a[..., :, p] - s * a[..., :, q]
                col_q = s * a[..., :, p] + c * a[..., :, q]
                a[..., :, p] = col_p
                a[..., :, q] = col_q
                vp = c * v[..., :, p] - s * v[..., :, q]
                vq = s * v[..., :, p] + c * v[..., :, q]
                v[..., :, p] = vp
                v[..., :, q] = vq
    return torch.diagonal(a, dim1=-2, dim2=-1), v


def smallest_eigvec_9x9(ata: torch.Tensor, iterations: int = 8,
                        method: str = "jacobi") -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of (..., 9, 9) SPD
    matrices. "eigh" maps to torch.linalg.eigh (JAX's jnp.linalg.eigh),
    "jacobi" to fixed-sweep cyclic Jacobi, "inverse_iteration" to
    shifted inverse iteration through a Cholesky factor."""
    if method == "eigh":
        _, v = torch.linalg.eigh(ata)
        return v[..., 0]
    if method == "jacobi":
        d, v = jacobi_eigh_small(ata, sweeps=max(1, min(iterations, 10)))
        best = torch.argmin(d, dim=-1)  # (...,)
        idx = best[..., None, None].expand(*v.shape[:-1], 1)
        return torch.gather(v, -1, idx)[..., 0]
    if method != "inverse_iteration":
        raise ValueError(method)
    shift = (torch.diagonal(ata, dim1=-2, dim2=-1).sum(-1) / 9.0 * 1e-4
             + 1e-12)
    eye = torch.eye(9, dtype=ata.dtype, device=ata.device)
    L = torch.linalg.cholesky(ata + shift[..., None, None] * eye)
    x = torch.full((*ata.shape[:-2], 9, 1), 1.0 / 3.0, dtype=ata.dtype,
                   device=ata.device)
    for _ in range(iterations):
        x = torch.cholesky_solve(x, L)
        x = x / torch.clamp_min(torch.linalg.vector_norm(
            x, dim=-2, keepdim=True), _EPS)
    return x[..., 0]


def nullspace_8x9_qr(rows: torch.Tensor) -> torch.Tensor:
    """Unit nullspace vector of (..., 8, 9) systems via 28 Givens
    rotations and back substitution with x[8] = 1 (the same rotation
    order and EPS guards as multih_tpu.ops.geometry.nullspace_8x9_qr)."""
    r = [rows[..., i, :] for i in range(8)]
    for c in range(8):
        for k in range(c + 1, 8):
            a, b = r[c][..., c], r[k][..., c]
            d = torch.sqrt(a * a + b * b)
            d_safe = torch.clamp_min(d, _EPS)
            live = d > _EPS
            cs = torch.where(live, a / d_safe, 1.0)[..., None]
            sn = torch.where(live, b / d_safe, 0.0)[..., None]
            rc = cs * r[c] + sn * r[k]
            rk = -sn * r[c] + cs * r[k]
            r[c], r[k] = rc, rk
    x = [None] * 9
    x[8] = torch.ones_like(rows[..., 0, 0])
    for i in reversed(range(8)):
        acc = torch.zeros_like(x[8])
        for j in range(i + 1, 9):
            acc = acc + r[i][..., j] * x[j]
        x[i] = -acc / _signed_clamp(r[i][..., i])
    v = torch.stack(x, dim=-1)
    return v / torch.clamp_min(torch.linalg.vector_norm(
        v, dim=-1, keepdim=True), _EPS)


# ---------------------------------------------------------------------------
# homography solves
# ---------------------------------------------------------------------------

def _normalize_sign(H: torch.Tensor) -> torch.Tensor:
    """Frobenius-normalize (..., 3, 3) and make h33 >= 0."""
    H = H / torch.clamp_min(torch.linalg.matrix_norm(H)[..., None, None],
                            _EPS)
    return H * torch.where(H[..., 2:3, 2:3] < 0, -1.0, 1.0)


def _denormalize_h(Hn, T1, T2):
    """x2 = T2^-1 Hn T1 x1 (batched), Frobenius-normalized, h33 >= 0."""
    return _normalize_sign(_similarity_inverse(T2) @ Hn @ T1)


def homography_4pt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Minimal 4-point homographies via Givens-QR nullspace:
    (..., 4, 2) x2 -> (..., 3, 3)."""
    x1n, T1 = hartley_normalize(x1)
    x2n, T2 = hartley_normalize(x2)
    rows = dlt_rows(x1n, x2n).reshape(*x1.shape[:-2], 8, 9)
    h = nullspace_8x9_qr(rows)
    return _denormalize_h(h.reshape(*h.shape[:-1], 3, 3), T1, T2)


# the JAX package's vmapped name: (S, 4, 2) x (S, 4, 2) -> (S, 3, 3)
homography_4pt_batch_qr = homography_4pt


# ---------------------------------------------------------------------------
# moment-based batched weighted refit (multih_tpu.ops.geometry, "C12 at
# scale"): every candidate's normal matrix is a linear combination of
# thirty shared per-point moments, so the batched refit is one (C, N) x
# (N, 30) matmul plus a per-candidate 9x9 assembly.
# ---------------------------------------------------------------------------

class RefitBasis(NamedTuple):
    """Shared per-point refit features (build once per (x1, x2) pair)."""

    feats: torch.Tensor  # (N, 30) moment features in the global frame
    T1g: torch.Tensor    # (3, 3) global similarity on x1
    T2g: torch.Tensor    # (3, 3) global similarity on x2


def global_norm(p: torch.Tensor):
    """(N, 2) -> (points, similarity) of the unweighted global
    pre-normalization every moment refit starts from: centroid 0, RMS
    radius sqrt(2), so the accumulated moments stay O(1) in fp32."""
    mean = p.mean(0)
    cen = p - mean
    rms = torch.sqrt(torch.clamp_min((cen ** 2).sum(-1).mean(), _EPS))
    s = torch.full_like(rms, _SQRT2) / rms
    return cen * s, _similarity(s, mean[0], mean[1])


def prepare_refit(x1: torch.Tensor, x2: torch.Tensor) -> RefitBasis:
    """(N, 2) x (N, 2) -> moment features for `homography_refit_batch`."""
    x1g, T1g = global_norm(x1)
    x2g, T2g = global_norm(x2)
    x, y = x1g[:, 0], x1g[:, 1]
    u, v = x2g[:, 0], x2g[:, 1]
    one = torch.ones_like(x)
    m = torch.stack([one, u, v, u * u, v * v], dim=1)          # (N, 5)
    p = torch.stack([one, x, y, x * x, x * y, y * y], dim=1)   # (N, 6)
    feats = (m[:, :, None] * p[:, None, :]).reshape(-1, 30)
    return RefitBasis(feats, T1g, T2g)


def _batched_kron3(a, b):
    """kron of (C, 3, 3) with (C, 3, 3) -> (C, 9, 9)."""
    return torch.einsum("cij,ckl->cikjl", a, b).reshape(a.shape[0], 9, 9)


def _moments_to_ata(mom: torch.Tensor):
    """(C, 5, 6) moment tables -> ((C, 9, 9) normalized-DLT normal
    matrices, (s1, c1x, c1y, s2, c2x, c2y) Hartley parameters, each (C,))."""
    wsum = torch.clamp_min(mom[:, 0, 0], _EPS)
    c1x, c1y = mom[:, 0, 1] / wsum, mom[:, 0, 2] / wsum
    rms1 = torch.sqrt(torch.clamp_min(
        (mom[:, 0, 3] + mom[:, 0, 5]) / wsum - (c1x * c1x + c1y * c1y), _EPS
    ))
    s1 = torch.full_like(rms1, _SQRT2) / rms1
    c2x, c2y = mom[:, 1, 0] / wsum, mom[:, 2, 0] / wsum
    rms2 = torch.sqrt(torch.clamp_min(
        (mom[:, 3, 0] + mom[:, 4, 0]) / wsum - (c2x * c2x + c2y * c2y), _EPS
    ))
    s2 = torch.full_like(rms2, _SQRT2) / rms2

    def P(mi):  # second-moment matrix of [x, y, 1] under m-basis row mi
        r = mom[:, mi]
        return torch.stack([
            torch.stack([r[:, 3], r[:, 4], r[:, 1]], dim=-1),
            torch.stack([r[:, 4], r[:, 5], r[:, 2]], dim=-1),
            torch.stack([r[:, 1], r[:, 2], r[:, 0]], dim=-1),
        ], dim=-2)

    P0, Pu, Pv, Pu2, Pv2 = P(0), P(1), P(2), P(3), P(4)
    Z = torch.zeros_like(P0)
    # Sa = sum w (aa^T (x) pp^T), a = [0,-1,v];  Sb with b = [1,0,-u]
    Sa = torch.cat([
        torch.cat([Z, Z, Z], dim=2),
        torch.cat([Z, P0, -Pv], dim=2),
        torch.cat([Z, -Pv, Pv2], dim=2),
    ], dim=1)
    Sb = torch.cat([
        torch.cat([P0, Z, -Pu], dim=2),
        torch.cat([Z, Z, Z], dim=2),
        torch.cat([-Pu, Z, Pu2], dim=2),
    ], dim=1)
    T1c = _similarity(s1, c1x, c1y)
    zero = torch.zeros_like(s2)
    one = torch.ones_like(s2)
    Ga = torch.stack([
        torch.stack([one, zero, zero], dim=-1),
        torch.stack([zero, one, zero], dim=-1),
        torch.stack([zero, s2 * c2y, s2], dim=-1),
    ], dim=-2)
    Gb = torch.stack([
        torch.stack([one, zero, zero], dim=-1),
        torch.stack([zero, one, zero], dim=-1),
        torch.stack([s2 * c2x, zero, s2], dim=-1),
    ], dim=-2)
    Ka = _batched_kron3(Ga, T1c)
    Kb = _batched_kron3(Gb, T1c)
    ata = Ka @ Sa @ Ka.transpose(1, 2) + Kb @ Sb @ Kb.transpose(1, 2)
    return ata, (s1, c1x, c1y, s2, c2x, c2y)


def _h_from_nullvec(h, params, T1g, T2g):
    """(C, 9) unit nullspace vectors -> (C, 3, 3) homographies in the raw
    frame: through the per-candidate Hartley similarities, then out of the
    global pre-normalization (H = T2g^-1 Hg T1g)."""
    s1, c1x, c1y, s2, c2x, c2y = params
    Hg = _denormalize_h(h.reshape(-1, 3, 3), _similarity(s1, c1x, c1y),
                        _similarity(s2, c2x, c2y))
    return _normalize_sign(_similarity_inverse(T2g) @ Hg @ T1g)


def homography_refit_batch(
    weights: torch.Tensor,
    basis: RefitBasis,
    eig_method: str = "jacobi",
    eig_iterations: int = 8,
    eig_kernel: bool = False,
) -> torch.Tensor:
    """Weighted DLT refit of C candidates: (C, N) weights -> (C, 3, 3).

    With `eig_kernel` the 9x9 eigensolves run in the hand-written Jacobi
    kernel (ops/kernels/eig_kernel.py, 6 sweeps) — the counterpart of the
    JAX package's eig_pallas; otherwise `smallest_eigvec_9x9(a,
    eig_iterations, eig_method)`, as geometry.py:506-509 does."""
    mom = weights @ basis.feats  # (C, 30)
    atas, params = _moments_to_ata(mom.reshape(-1, 5, 6))
    hs = smallest_eigvecs(atas, eig_method, eig_iterations, eig_kernel)
    return _h_from_nullvec(hs, params, basis.T1g, basis.T2g)


def smallest_eigvecs(atas: torch.Tensor, eig_method: str,
                     eig_iterations: int, eig_kernel: bool) -> torch.Tensor:
    """(C, 9, 9) -> (C, 9): the hand-written Jacobi kernel when
    `eig_kernel`, else `smallest_eigvec_9x9` (geometry.py:502-509's
    rule, shared by the homography and the fundamental refit)."""
    if eig_kernel:
        from multih_tpu_torch.ops.kernels import eig_kernel as ek

        return ek.smallest_eigvec_9x9_batch(atas)
    return smallest_eigvec_9x9(atas, eig_iterations, eig_method)


def quad_degenerate_t(px: torch.Tensor, py: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Coordinate-major degeneracy test: px, py are (4, S); True where any
    3 of a quad's 4 points are (near-)collinear. Returns (S,) bool."""
    def tri_area2(a, b, c):
        return torch.abs(
            (px[b] - px[a]) * (py[c] - py[a])
            - (py[b] - py[a]) * (px[c] - px[a])
        )

    d = tri_area2(0, 1, 2) < eps
    d |= tri_area2(0, 1, 3) < eps
    d |= tri_area2(0, 2, 3) < eps
    d |= tri_area2(1, 2, 3) < eps
    return d


# ---------------------------------------------------------------------------
# residuals — hypotheses x correspondences
# ---------------------------------------------------------------------------

def _forward_transfer_sq(H, x1h, x2):
    """||pi(H x1) - x2||^2: H (..., 3, 3), x1h (N, 3), x2 (N, 2) ->
    (..., N)."""
    y = x1h @ H.transpose(-1, -2)  # (..., N, 3)
    return ((from_homogeneous(y) - x2) ** 2).sum(-1)


def transfer_error_sq(H, x1, x2):
    return _forward_transfer_sq(H, to_homogeneous(x1), x2)


def symmetric_transfer_error_sq(H, x1, x2):
    """Forward + backward transfer; the backward map is the adjugate."""
    fwd = _forward_transfer_sq(H, to_homogeneous(x1), x2)
    bwd = _forward_transfer_sq(adjugate_3x3(H), to_homogeneous(x2), x1)
    return fwd + bwd


def sampson_error_sq_h(H, x1, x2):
    """First-order (Sampson) reprojection error of homographies:
    H (..., 3, 3) -> (..., N)."""
    Hx = to_homogeneous(x1) @ H.transpose(-1, -2)  # (..., N, 3)
    u, v = x2[..., 0], x2[..., 1]
    e1 = v * Hx[..., 2] - Hx[..., 1]
    e2 = Hx[..., 0] - u * Hx[..., 2]
    h = H.reshape(*H.shape[:-2], 9)

    def hq(i):  # (..., 1): broadcasts against the point axis
        return h[..., i][..., None]

    d1x = v * hq(6) - hq(3)
    d1y = v * hq(7) - hq(4)
    d1u = torch.zeros_like(e1)
    d1v = Hx[..., 2]
    d2x = hq(0) - u * hq(6)
    d2y = hq(1) - u * hq(7)
    d2u = -Hx[..., 2]
    d2v = torch.zeros_like(e2)
    a = d1x ** 2 + d1y ** 2 + d1u ** 2 + d1v ** 2
    b = d1x * d2x + d1y * d2y + d1u * d2u + d1v * d2v
    c = d2x ** 2 + d2y ** 2 + d2u ** 2 + d2v ** 2
    det = torch.clamp_min(a * c - b * b, _EPS)
    return (c * e1 * e1 - 2.0 * b * e1 * e2 + a * e2 * e2) / det


_RESIDUALS = {
    "transfer": transfer_error_sq,
    "symmetric": symmetric_transfer_error_sq,
    "sampson": sampson_error_sq_h,
}


def residual_matrix(Hs, x1, x2, kind: str = "symmetric") -> torch.Tensor:
    """(S, 3, 3) hypotheses x (N, 2) correspondences -> (S, N) squared
    residuals."""
    return _RESIDUALS[kind](Hs, x1, x2)
