"""Epipolar geometry in PyTorch: the weighted 8-point fundamental matrix,
RANSAC-style F estimation and the affine + F one-point homography (the
Multi-H paper's own hypothesis source, §3.1).

Counterpart of ``multih_tpu/ops/epipolar.py``. Where the JAX version is
vmapped, the functions here are batch-first over leading dimensions, in
the JAX version's float32 operation order, apart from `fundamental_8pt`,
which solves float32 input in float64. The eigen- and singular-value
problems are ``torch.linalg`` calls, as the reference's are jnp.linalg
calls outside any Pallas kernel; on CUDA each of them reads its
convergence flag back to the host.
"""

from __future__ import annotations

import torch

from multih_tpu_torch.ops import geometry, sampling

_EPS = 1e-12


# ---------------------------------------------------------------------------
# fundamental matrix
# ---------------------------------------------------------------------------

def _f_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Epipolar constraint rows x2h^T F x1h = 0: (..., N, 2) x2 ->
    (..., N, 9), F row-major."""
    x, y = x1[..., 0], x1[..., 1]
    u, v = x2[..., 0], x2[..., 1]
    one = torch.ones_like(x)
    return torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, one], dim=-1)


def fundamental_8pt(x1: torch.Tensor, x2: torch.Tensor,
                    weights: torch.Tensor | None = None,
                    eig_method: str = "eigh") -> torch.Tensor:
    """Weighted normalized 8-point fundamental matrices, ||F|| = 1, rank 2,
    F[2, 2] >= 0.

    x1, x2: (..., N, 2); weights: optional (..., N). Shared (N, 2) points
    with (C, N) weights give C refits in one batch (the direct refit of
    `pipeline._refit_direct`). Rank 2 by a 3x3 SVD with the smallest
    singular value zeroed.

    Float32 input is solved in float64 and rounded at the end, as K2
    solves its minimal homographies: the normal matrix's float32 sum and
    its float32 eigensolve each move F's null vector by up to ~7e-3 of
    float64 (an F of two motions' members), and by how much depends on
    the CPU's BLAS and LAPACK paths."""
    if x1.dtype == torch.float32:
        return fundamental_8pt(
            x1.double(), x2.double(),
            None if weights is None else weights.double(),
            eig_method).to(torch.float32)
    x1n, T1 = geometry.hartley_normalize(x1, weights)
    x2n, T2 = geometry.hartley_normalize(x2, weights)
    rows = _f_rows(x1n, x2n)  # (..., N, 9)
    lhs = rows if weights is None else rows * weights[..., None]
    ata = torch.einsum("...ni,...nj->...ij", lhs, rows)
    f = geometry.smallest_eigvec_9x9(ata, method=eig_method)
    Fn = f.reshape(*f.shape[:-1], 3, 3)
    u, s, vh = torch.linalg.svd(Fn)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    Fn = (u * s[..., None, :]) @ vh
    return geometry._normalize_sign(T2.transpose(-1, -2) @ Fn @ T1)


def sampson_error_f(F: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric error of the epipolar constraint.
    F: (..., 3, 3); x1, x2: (N, 2) -> (..., N)."""
    x1h = geometry.to_homogeneous(x1)  # (N, 3)
    x2h = geometry.to_homogeneous(x2)
    Fx1 = x1h @ F.transpose(-1, -2)    # (..., N, 3)
    Ftx2 = x2h @ F                      # (..., N, 3)
    num = (x2h * Fx1).sum(-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2
           + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)
    return num / torch.clamp_min(den, _EPS)


# the two draws of `estimate_fundamental`, each a stream of the draw
# source: a replaying source maps ("epipolar", j) to half j of the
# reference's k_f split (epipolar.py:106)
F_STREAMS = (("epipolar", 0), ("epipolar", 1))


def estimate_fundamental(draws, x1: torch.Tensor, x2: torch.Tensor,
                         valid: torch.Tensor, n_samples: int = 512,
                         threshold: float = 1.0,
                         lo_rounds: int = 2) -> torch.Tensor:
    """RANSAC-style F estimation in one batched sweep + LO polish
    (epipolar.py:86).

    Each minimal sample is two 4-tuples from the collision-free sampler,
    drawn under the streams `F_STREAMS` of the draw source `draws` (a
    cross-half duplicate only lowers that sample's rank, and it loses on
    its count). Samples are scored by Sampson inliers; the best is refit
    on its Tukey-weighted inliers `lo_rounds` times, each refit kept if
    its inlier count does not drop. The reference's lax.scan is a Python
    loop whose keep rule is a torch.where: nothing waits on the device."""
    thr = torch.full((), threshold ** 2, dtype=x1.dtype, device=x1.device)
    mask = valid > 0
    idx = torch.cat([sampling.sample_indices(draws, s, n_samples, mask)
                     for s in F_STREAMS], dim=1)  # (S, 8)
    Fs = fundamental_8pt(x1[idx], x2[idx])  # (S, 3, 3)
    counts = ((sampson_error_f(Fs, x1, x2) < thr) * valid[None, :]).sum(1)
    F = Fs[torch.argmax(counts)]  # jnp.argmax: the first maximum
    for _ in range(lo_rounds):
        e = sampson_error_f(F, x1, x2)
        w = torch.clamp_min(1.0 - e / thr, 0.0) ** 2 * (e < thr) * valid
        Fn = fundamental_8pt(x1, x2, w)
        better = (((sampson_error_f(Fn, x1, x2) < thr) * valid).sum()
                  >= ((e < thr) * valid).sum())
        F = torch.where(better, Fn, F)
    return F


def epipole(F: torch.Tensor, which: str = "right") -> torch.Tensor:
    """Null vectors of (..., 3, 3) F: the right epipole e' (F^T e' = 0) or
    the left one e (F e = 0), as the smallest eigenvector of F F^T or
    F^T F, unit norm. Its sign is whatever eigh gives: the one-point
    homography is invariant to it.

    Expects F in normalized image coordinates (order-1 entries): a pixel
    F is nearly rank 1 and float32 cannot separate its null direction
    (homography_one_point scales first)."""
    Ft = F.transpose(-1, -2)
    m = F @ Ft if which == "right" else Ft @ F
    _, v = torch.linalg.eigh(m)
    e = v[..., :, 0]
    return e / torch.clamp_min(
        torch.linalg.vector_norm(e, dim=-1, keepdim=True), _EPS)


# ---------------------------------------------------------------------------
# affine + F one-point homography
# ---------------------------------------------------------------------------

def _cross_mat(e: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices [e]_x."""
    z = torch.zeros_like(e[..., 0])
    return torch.stack([
        torch.stack([z, -e[..., 2], e[..., 1]], dim=-1),
        torch.stack([e[..., 2], z, -e[..., 0]], dim=-1),
        torch.stack([-e[..., 1], e[..., 0], z], dim=-1),
    ], dim=-2)


def _lstsq_min_norm(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares of (..., m, n) M x = (..., m) b by an
    SVD, singular values below eps * max(m, n) * s_max treated as zero:
    jnp.linalg.lstsq's semantics at its default rcond, step for step.
    Not torch.linalg.lstsq: on CUDA its only driver is the QR-based
    gels, which assumes full rank, and the one-point system loses rank
    (e.g. at a point on the epipole's line, where both point rows
    vanish)."""
    u, s, vh = torch.linalg.svd(M, full_matrices=False)
    rcond = torch.finfo(M.dtype).eps * max(M.shape[-2:])
    keep = s >= rcond * s[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    utb = u.transpose(-1, -2) @ b[..., None]
    return (vh.transpose(-1, -2) @ (s_inv[..., None] * utb))[..., 0]


def homography_one_point(F: torch.Tensor, p1: torch.Tensor,
                         p2: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Homographies from one correspondence, its local affine frame and F
    (epipolar.py:152): F (..., 3, 3); p1, p2 (..., 2); A (..., 2, 2) the
    local affine dp2/dp1 -> H (..., 3, 3), ||H|| = 1, H[2, 2] >= 0.
    Leading dimensions broadcast: a shared (3, 3) F with (N, ...) points
    is the batch over correspondences (`homography_one_point_batch`).

    Every homography compatible with F is H = [e']_x F - e' v^T; the
    point (2 equations) and the affine frame (4) are linear in v, a 6x3
    least squares solved by `_lstsq_min_norm`. Both images are first
    scaled by S = diag(s, s, 1), s the point's largest coordinate (at
    least 1), so the system's columns are of one magnitude in float32;
    H = S H' S^-1 at the end."""
    one = torch.ones_like(p1[..., 0])
    s = torch.clamp_min(torch.maximum(p1.abs().amax(-1), p2.abs().amax(-1)),
                        1.0)
    S = torch.diag_embed(torch.stack([s, s, one], dim=-1))
    S_inv = torch.diag_embed(torch.stack([1.0 / s, 1.0 / s, one], dim=-1))
    F = S.transpose(-1, -2) @ F @ S
    F = F / torch.clamp_min(torch.linalg.matrix_norm(F)[..., None, None],
                            _EPS)
    p1 = p1 / s[..., None]
    p2 = p2 / s[..., None]

    e2 = epipole(F, "right")              # (..., 3)
    H0 = _cross_mat(e2) @ F               # pencil base
    p1h = geometry.to_homogeneous(p1)     # (..., 3)
    y0 = (H0 @ p1h[..., None])[..., 0]    # H0 p1h

    # point rows: (e2_i - q_i e2_3) (v . p1h) = y0_i - q_i y0_3
    q = (p2[..., 0], p2[..., 1])
    rows, rhs = [], []
    for i in range(2):
        rows.append((e2[..., i] - q[i] * e2[..., 2])[..., None] * p1h)
        rhs.append(y0[..., i] - q[i] * y0[..., 2])
    # affine rows: A_ij y3 = h_i[j] - q_i h3[j] at p1, linear in v, for the
    # spatial derivatives j = 0, 1
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    for i in range(2):
        for j in range(2):
            rows.append(
                (-A[..., i, j] * e2[..., 2])[..., None] * p1h
                + (e2[..., i] - q[i] * e2[..., 2])[..., None] * eye[j]
            )
            rhs.append(-A[..., i, j] * y0[..., 2] + H0[..., i, j]
                       - q[i] * H0[..., 2, j])
    M = torch.stack(rows, dim=-2)  # (..., 6, 3)
    b = torch.stack(rhs, dim=-1)   # (..., 6)
    v = _lstsq_min_norm(M, b)
    H = H0 - e2[..., :, None] * v[..., None, :]
    # back to pixel coordinates
    return geometry._normalize_sign(S @ H @ S_inv)


# the reference's vmap over correspondences: F (3, 3) shared; p1, p2
# (N, 2); A (N, 2, 2) -> (N, 3, 3), by broadcasting
homography_one_point_batch = homography_one_point
