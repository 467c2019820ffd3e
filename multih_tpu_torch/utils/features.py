"""Local affine frames for the affine one-point hypotheses (numpy only).

Counterpart of ``multih_tpu/utils/features.py``, without its OpenCV
front end (`detect_and_match` is not ported yet): the ground-truth
style frames of `affines_from_homographies`, a byte-for-byte copy, which
the tests and `chip_smoke.py` feed to ``fit(affines=...)``.
"""

from __future__ import annotations

import numpy as np


def affines_from_homographies(Hs, labels, x1, outlier_label):
    """GT-style affine frames: the Jacobian of each point's assigned
    homography at the point; the identity for outliers (label
    `outlier_label` or negative)."""
    n = x1.shape[0]
    A = np.tile(np.eye(2, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        l = labels[i]
        if l == outlier_label or l < 0:
            continue
        H = Hs[l]
        x, y = x1[i]
        w = H[2, 0] * x + H[2, 1] * y + H[2, 2]
        u = H[0, 0] * x + H[0, 1] * y + H[0, 2]
        v = H[1, 0] * x + H[1, 1] * y + H[1, 2]
        # d(u/w)/dx = (H00*w - u*H20)/w^2 etc.
        A[i] = np.array(
            [
                [H[0, 0] * w - u * H[2, 0], H[0, 1] * w - u * H[2, 1]],
                [H[1, 0] * w - v * H[2, 0], H[1, 1] * w - v * H[2, 1]],
            ],
            np.float32,
        ) / (w * w)
    return A
