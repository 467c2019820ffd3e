"""Feature front end and local affine frames for the affine one-point
hypotheses (numpy, and OpenCV on the host).

Counterpart of ``multih_tpu/utils/features.py``: `detect_and_match`,
SIFT + ratio-test matching with a similarity frame for each match (the
CLI's ``fit-images``; OpenCV is imported only when it runs), and the
ground-truth style frames of `affines_from_homographies`, a byte-for-byte
copy, which the tests and `chip_smoke.py` feed to ``fit(affines=...)``.
"""

from __future__ import annotations

import numpy as np

from multih_tpu_torch.utils.data import CorrespondenceSet


def detect_and_match(
    img1: np.ndarray,
    img2: np.ndarray,
    max_features: int = 4000,
    ratio: float = 0.8,
    name: str = "pair",
):
    """SIFT + ratio-test matching (features.py:19).

    Returns (CorrespondenceSet, affines (N, 2, 2) float32) where affines
    are the similarity transforms implied by the keypoints' scale and
    orientation change (local approximation of dp2/dp1). Raises
    ImportError without OpenCV."""
    import cv2

    sift = cv2.SIFT_create(nfeatures=max_features)
    if img1.ndim == 3:
        img1 = cv2.cvtColor(img1, cv2.COLOR_BGR2GRAY)
    if img2.ndim == 3:
        img2 = cv2.cvtColor(img2, cv2.COLOR_BGR2GRAY)
    kp1, des1 = sift.detectAndCompute(img1, None)
    kp2, des2 = sift.detectAndCompute(img2, None)
    if not kp1 or not kp2:
        return CorrespondenceSet(
            np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32),
            None, name,
        ), np.zeros((0, 2, 2), np.float32)

    matcher = cv2.BFMatcher(cv2.NORM_L2)
    knn = matcher.knnMatch(des1, des2, k=2)
    x1, x2, affines = [], [], []
    for pair in knn:
        if len(pair) < 2:
            continue
        m, n = pair
        if m.distance < ratio * n.distance:
            a, b = kp1[m.queryIdx], kp2[m.trainIdx]
            x1.append(a.pt)
            x2.append(b.pt)
            ds = (b.size / max(a.size, 1e-6))
            dth = np.deg2rad(b.angle - a.angle)
            c, s = np.cos(dth), np.sin(dth)
            affines.append(ds * np.array([[c, -s], [s, c]]))
    x1 = np.asarray(x1, np.float32).reshape(-1, 2)
    x2 = np.asarray(x2, np.float32).reshape(-1, 2)
    affines = np.asarray(affines, np.float32).reshape(-1, 2, 2)
    return CorrespondenceSet(x1, x2, None, name), affines


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
