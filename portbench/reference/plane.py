"""Plane (homography) model in float64: the symmetric transfer residual
and the Tukey-weighted normalized DLT refit that the fit's refits
compute (Hartley, Zisserman: Multiple View Geometry, 2nd ed., alg. 4.2,
with weights)."""

from __future__ import annotations

import numpy as np

from portbench.reference.common import hartley, homogeneous, smallest_eigvec

MINIMAL_POINTS = 4


def _transfer_sq(H: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    y = homogeneous(a) @ H.T
    with np.errstate(divide="ignore", invalid="ignore"):
        d = y[:, :2] / y[:, 2:3] - b
    return (d ** 2).sum(1)


def residual(H: np.ndarray, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Squared symmetric transfer error (px^2) of each correspondence:
    forward through H, back through its inverse."""
    H = np.asarray(H, np.float64)
    try:
        Hi = np.linalg.inv(H)
    except np.linalg.LinAlgError:
        return np.full(x1.shape[0], np.inf)
    r = _transfer_sq(H, x1, x2) + _transfer_sq(Hi, x2, x1)
    return np.where(np.isfinite(r), r, np.inf)


def refit(x1: np.ndarray, x2: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The homography minimizing the weighted algebraic DLT error of the
    correspondences, in weighted Hartley coordinates, unit Frobenius
    norm."""
    T1, T2 = hartley(x1, w), hartley(x2, w)
    a = homogeneous(x1) @ T1.T
    b = homogeneous(x2) @ T2.T
    x, y = a[:, 0], a[:, 1]
    u, v = b[:, 0], b[:, 1]
    z, o = np.zeros_like(x), np.ones_like(x)
    rx = np.stack([z, z, z, -x, -y, -o, v * x, v * y, v], 1)
    ry = np.stack([x, y, o, z, z, z, -u * x, -u * y, -u], 1)
    ata = (rx.T * w) @ rx + (ry.T * w) @ ry
    Hn = smallest_eigvec(ata).reshape(3, 3)
    H = np.linalg.inv(T2) @ Hn @ T1
    return H / np.linalg.norm(H)
