"""Motion (fundamental matrix) model in float64: the Sampson residual and
the Tukey-weighted normalized 8-point refit with rank 2 enforced in the
normalized frame (Hartley: In defense of the eight-point algorithm,
PAMI 1997, with weights)."""

from __future__ import annotations

import numpy as np

from portbench.reference.common import hartley, homogeneous, smallest_eigvec

MINIMAL_POINTS = 8


def residual(F: np.ndarray, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Squared Sampson error (px^2) of each correspondence."""
    F = np.asarray(F, np.float64)
    a, b = homogeneous(x1), homogeneous(x2)
    l = a @ F.T          # epilines in image 2
    m = b @ F            # epilines in image 1
    e = (b * l).sum(1)
    den = l[:, 0] ** 2 + l[:, 1] ** 2 + m[:, 0] ** 2 + m[:, 1] ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        r = e * e / den
    return np.where(np.isfinite(r), r, np.inf)


def refit(x1: np.ndarray, x2: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The rank-2 fundamental matrix of the weighted normalized 8-point
    algorithm: the least weighted algebraic error x2^T F x1, then the
    nearest rank-2 matrix in the normalized frame; unit Frobenius
    norm."""
    T1, T2 = hartley(x1, w), hartley(x2, w)
    a = homogeneous(x1) @ T1.T
    b = homogeneous(x2) @ T2.T
    rows = (b[:, :, None] * a[:, None, :]).reshape(-1, 9)
    Fn = smallest_eigvec((rows.T * w) @ rows).reshape(3, 3)
    u, s, vt = np.linalg.svd(Fn)
    Fn = u @ np.diag([s[0], s[1], 0.0]) @ vt
    F = T2.T @ Fn @ T1
    return F / np.linalg.norm(F)
