"""Fundamental-matrix model ops in PyTorch: the multi-motion model class.

Counterpart of ``multih_tpu/ops/fmodel.py``, in its order and with its
float32 operation order where the two can share one. Everything is
batch-first over leading dimensions where the JAX version is vmapped:

- residuals: Sampson, symmetric epipolar and one-sided epipolar
  distance, under the config's residual names (sampson / symmetric /
  transfer);
- minimal solvers: the 8-point algorithm through the Givens-QR nullspace
  behind a fixed generic column rotation `_Q0` (axis-aligned translation
  gives F33 = 0, which would break the back substitution's x[8] = 1), and
  the overdetermined m-point solve (normal equations + 9x9 eigensolve);
- the moment refit: one (C, N) x (N, 36) matmul plus a per-candidate 9x9
  assembly, weighted Hartley normalization recovered from the moments;
- rank 2: the Eckart-Young step F - (F v) v^T with v the smallest
  eigenvector of F^T F (3x3 fixed-sweep Jacobi), in the NORMALIZED frame
  (docs/PERF.md "The raw-frame rank-2 bug").

The refit's 9x9 eigensolves run in the Jacobi kernel (K3) on CUDA
tensors when the caller asks (`eig_kernel`); the 8-point batch solve is
plain PyTorch, as the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from multih_tpu_torch.ops import geometry

_EPS = 1e-12

# The fixed generic rotation of the JAX package (fmodel.py:63-65): the
# same numpy draw, so both solvers rotate by the same matrix.
_Q0 = np.linalg.qr(
    np.random.default_rng(20260818).normal(size=(9, 9))
)[0].astype(np.float32)


# ---------------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------------

def _epipolar_terms(Fs: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """l = F x1h (epiline in image 2), m = F^T x2h (epiline in image 1),
    e = x2h . l. Fs: (..., 3, 3); x1, x2: (N, 2) ->
    ((..., N, 3), (..., N, 3), (..., N))."""
    x1h = geometry.to_homogeneous(x1)
    x2h = geometry.to_homogeneous(x2)
    l = x1h @ Fs.transpose(-1, -2)
    m = x2h @ Fs
    e = (x2h * l).sum(-1)
    return l, m, e


def transfer_error_sq_f(Fs, x1, x2):
    """One-sided squared epipolar distance d(x2, F x1h)^2."""
    l, _, e = _epipolar_terms(Fs, x1, x2)
    return e * e / torch.clamp_min(l[..., 0] ** 2 + l[..., 1] ** 2, _EPS)


def symmetric_epipolar_error_sq_f(Fs, x1, x2):
    """d(x2, F x1h)^2 + d(x1, F^T x2h)^2."""
    l, m, e = _epipolar_terms(Fs, x1, x2)
    e2 = e * e
    return (e2 / torch.clamp_min(l[..., 0] ** 2 + l[..., 1] ** 2, _EPS)
            + e2 / torch.clamp_min(m[..., 0] ** 2 + m[..., 1] ** 2, _EPS))


def sampson_error_sq_f(Fs, x1, x2):
    """First-order (Sampson) squared error of the epipolar constraint;
    the clamp is on the sum of both epilines' squared normals."""
    l, m, e = _epipolar_terms(Fs, x1, x2)
    den = l[..., 0] ** 2 + l[..., 1] ** 2 + m[..., 0] ** 2 + m[..., 1] ** 2
    return e * e / torch.clamp_min(den, _EPS)


_RESIDUALS_F = {
    "transfer": transfer_error_sq_f,
    "symmetric": symmetric_epipolar_error_sq_f,
    "sampson": sampson_error_sq_f,
}


def residual_matrix_f(Fs, x1, x2, kind: str = "sampson") -> torch.Tensor:
    """(S, 3, 3) fundamental matrices x (N, 2) correspondences -> (S, N)
    squared residuals (px^2-comparable)."""
    return _RESIDUALS_F[kind](Fs, x1, x2)


# ---------------------------------------------------------------------------
# minimal solvers
# ---------------------------------------------------------------------------

def _rank2_project(F: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> closest rank-2 matrices (Frobenius): F - (F v) v^T,
    v the smallest eigenvector of F^T F by 5-sweep 3x3 Jacobi."""
    ftf = F.transpose(-1, -2) @ F
    d, v3 = geometry.jacobi_eigh_small(ftf, sweeps=5)
    best = torch.argmin(d, dim=-1)[..., None, None].expand(
        *v3.shape[:-1], 1)
    v = torch.gather(v3, -1, best)[..., 0]  # (..., 3)
    fv = (F @ v[..., None])[..., 0]
    return F - fv[..., :, None] * v[..., None, :]


def _canonical_f(F: torch.Tensor) -> torch.Tensor:
    """Frobenius-normalize with the sign of the largest-|.| entry made
    positive (F33 may be 0, unlike h33); argmax takes the first on ties,
    as jnp.argmax."""
    F = F / torch.clamp_min(torch.linalg.matrix_norm(F)[..., None, None],
                            _EPS)
    f = F.reshape(*F.shape[:-2], 9)
    lead = torch.gather(f, -1, torch.argmax(f.abs(), dim=-1, keepdim=True))
    return F * torch.where(lead < 0, -1.0, 1.0)[..., None].to(F.dtype)


def _epipolar_rows(x1n: torch.Tensor, x2n: torch.Tensor) -> torch.Tensor:
    """(..., m, 2) normalized points -> (..., m, 9) rows kron(x2h, x1h)."""
    x, y = x1n[..., 0], x1n[..., 1]
    u, v = x2n[..., 0], x2n[..., 1]
    one = torch.ones_like(x)
    return torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, one], dim=-1)


def _denormalize_f(Fn, T1, T2):
    """Rank 2 in the normalized frame, then F = T2^T Fn T1, canonical."""
    F = T2.transpose(-1, -2) @ _rank2_project(Fn) @ T1
    return _canonical_f(F)


def fundamental_8pt_minimal(p1: torch.Tensor, p2: torch.Tensor):
    """Minimal 8-point fundamental matrices via Givens-QR nullspace:
    (..., 8, 2) x2 -> (..., 3, 3), ||F|| = 1, rank 2."""
    q0 = torch.as_tensor(_Q0, dtype=p1.dtype, device=p1.device)
    x1n, T1 = geometry.hartley_normalize(p1)
    x2n, T2 = geometry.hartley_normalize(p2)
    rows = _epipolar_rows(x1n, x2n)  # (..., 8, 9)
    fv = geometry.nullspace_8x9_qr(rows @ q0) @ q0.T
    return _denormalize_f(fv.reshape(*fv.shape[:-1], 3, 3), T1, T2)


# the JAX package's vmapped name: (S, 8, 2) x (S, 8, 2) -> (S, 3, 3)
fundamental_8pt_batch_qr = fundamental_8pt_minimal


def fundamental_npt_minimal(p1: torch.Tensor, p2: torch.Tensor,
                            eig_iterations: int = 6,
                            eig_method: str = "eigh"):
    """Overdetermined small-sample solve: (..., m, 2) x2 with m > 8 ->
    (..., 3, 3), through the normal equations and the smallest
    eigenvector of the 9x9 A^T A."""
    x1n, T1 = geometry.hartley_normalize(p1)
    x2n, T2 = geometry.hartley_normalize(p2)
    rows = _epipolar_rows(x1n, x2n)  # (..., m, 9)
    ata = rows.transpose(-1, -2) @ rows
    fv = geometry.smallest_eigvec_9x9(ata, eig_iterations, eig_method)
    return _denormalize_f(fv.reshape(*fv.shape[:-1], 3, 3), T1, T2)


# the JAX package's vmapped name: (S, m, 2) x (S, m, 2) -> (S, 3, 3)
fundamental_npt_batch = fundamental_npt_minimal


# ---------------------------------------------------------------------------
# moment-based batched weighted refit
# ---------------------------------------------------------------------------

class FRefitBasis(NamedTuple):
    """Shared per-point refit features (build once per (x1, x2) pair)."""

    feats: torch.Tensor  # (N, 36) joint moment features, global frame
    T1g: torch.Tensor    # (3, 3) global similarity on x1
    T2g: torch.Tensor    # (3, 3) global similarity on x2


def _sym6(p: torch.Tensor) -> torch.Tensor:
    """(N, 2) -> (N, 6) unique entries of ph ph^T: [x^2, xy, y^2, x, y, 1]."""
    x, y = p[:, 0], p[:, 1]
    return torch.stack([x * x, x * y, y * y, x, y, torch.ones_like(x)],
                       dim=1)


# sym-pair index of (i, j) entries of ph ph^T in the _sym6 ordering
_SYM_IDX = np.array([[0, 1, 3], [1, 2, 4], [3, 4, 5]])


def prepare_refit_f(x1: torch.Tensor, x2: torch.Tensor) -> FRefitBasis:
    """(N, 2) x (N, 2) -> the 36 joint moment features of
    `fundamental_refit_batch`, after the global pre-normalization."""
    x1g, T1g = geometry.global_norm(x1)
    x2g, T2g = geometry.global_norm(x2)
    s1 = _sym6(x1g)
    s2 = _sym6(x2g)
    feats = (s2[:, :, None] * s1[:, None, :]).reshape(-1, 36)
    return FRefitBasis(feats, T1g, T2g)


def _moments_to_ata_f(mom: torch.Tensor):
    """(C, 6, 6) joint moment tables -> ((C, 9, 9) normalized epipolar
    normal matrices, (s1, c1x, c1y, s2, c2x, c2y) weighted Hartley
    parameters, each (C,)).

    ata[3i+k, 3j+l] = mom[sym(i, j), sym(k, l)], then the congruence
    (T2 (x) T1) ata (T2 (x) T1)^T applies the per-candidate Hartley
    normalization."""
    wsum = torch.clamp_min(mom[:, 5, 5], _EPS)
    c1x, c1y = mom[:, 5, 3] / wsum, mom[:, 5, 4] / wsum
    rms1 = torch.sqrt(torch.clamp_min(
        (mom[:, 5, 0] + mom[:, 5, 2]) / wsum - (c1x * c1x + c1y * c1y), _EPS
    ))
    s1 = torch.full_like(rms1, geometry._SQRT2) / rms1
    c2x, c2y = mom[:, 3, 5] / wsum, mom[:, 4, 5] / wsum
    rms2 = torch.sqrt(torch.clamp_min(
        (mom[:, 0, 5] + mom[:, 2, 5]) / wsum - (c2x * c2x + c2y * c2y), _EPS
    ))
    s2 = torch.full_like(rms2, geometry._SQRT2) / rms2

    idx = torch.as_tensor(_SYM_IDX, device=mom.device)
    # ata4[c, i, j, k, l] = mom[c, sym2(i, j), sym1(k, l)]
    ata4 = mom[:, idx[:, :, None, None], idx[None, None, :, :]]
    ata = ata4.permute(0, 1, 3, 2, 4).reshape(-1, 9, 9)  # [3i+k, 3j+l]
    K = geometry._batched_kron3(geometry._similarity(s2, c2x, c2y),
                                geometry._similarity(s1, c1x, c1y))
    return K @ ata @ K.transpose(1, 2), (s1, c1x, c1y, s2, c2x, c2y)


def _f_from_nullvec(f, params, T1g, T2g):
    """(C, 9) unit nullspace vectors -> (C, 3, 3) fundamental matrices:
    rank 2 enforced in the NORMALIZED frame, then out through the
    per-candidate weighted Hartley similarities and the global
    pre-normalization. The frame matters: in raw pixels F's entries span
    ~6 orders and the Frobenius-nearest rank-2 matrix can be another
    epipolar geometry (docs/PERF.md "The raw-frame rank-2 bug")."""
    s1, c1x, c1y, s2, c2x, c2y = params
    T1 = geometry._similarity(s1, c1x, c1y) @ T1g
    T2 = geometry._similarity(s2, c2x, c2y) @ T2g
    return _denormalize_f(f.reshape(-1, 3, 3), T1, T2)


def fundamental_refit_batch(
    weights: torch.Tensor,
    basis: FRefitBasis,
    eig_method: str = "eigh",
    eig_iterations: int = 6,
    eig_kernel: bool = False,
) -> torch.Tensor:
    """Weighted 8-point refit of C candidates in one matmul: (C, N)
    weights -> (C, 3, 3) rank-2 fundamental matrices. With `eig_kernel`
    the 9x9 eigensolves run in the Jacobi kernel (K3), the counterpart of
    the JAX package's eig_pallas."""
    mom = weights @ basis.feats  # (C, 36)
    atas, params = _moments_to_ata_f(mom.reshape(-1, 6, 6))
    fs = geometry.smallest_eigvecs(atas, eig_method, eig_iterations,
                                   eig_kernel)
    return _f_from_nullvec(fs, params, basis.T1g, basis.T2g)
