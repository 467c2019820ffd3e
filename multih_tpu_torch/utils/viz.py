"""Visualization: correspondences coloured by label, side by side on the
two images or on blank canvases when no images are given.

Counterpart of ``multih_tpu/utils/viz.py``, kept as its own copy. Host
side only (numpy and OpenCV, imported where it is used): a caller passes
numpy arrays, e.g. ``res.labels.cpu().numpy()``.
"""

from __future__ import annotations

import numpy as np

# distinct label colors (BGR for OpenCV)
_COLORS = [
    (60, 76, 231), (74, 195, 139), (255, 148, 0), (180, 119, 31),
    (153, 51, 255), (0, 215, 255), (128, 128, 240), (210, 160, 60),
    (90, 180, 250), (200, 200, 0), (30, 105, 210), (150, 70, 140),
    (0, 165, 255), (170, 230, 80), (230, 80, 170), (80, 80, 80),
]
_OUTLIER = (160, 160, 160)


def draw_labels(
    x1: np.ndarray,
    x2: np.ndarray,
    labels: np.ndarray,
    outlier_label: int,
    img1: np.ndarray | None = None,
    img2: np.ndarray | None = None,
    radius: int = 4,
):
    """Side-by-side visualization; returns a BGR uint8 image."""
    import cv2

    def canvas(img, pts):
        if img is not None:
            out = img.copy()
            if out.ndim == 2:
                out = cv2.cvtColor(out, cv2.COLOR_GRAY2BGR)
            return out
        w = int(np.max(pts[:, 0]) + 40) if len(pts) else 640
        h = int(np.max(pts[:, 1]) + 40) if len(pts) else 480
        return np.full((h, w, 3), 255, np.uint8)

    c1 = canvas(img1, x1)
    c2 = canvas(img2, x2)
    for (p, q, l) in zip(x1, x2, labels):
        col = (
            _OUTLIER if l == outlier_label
            else _COLORS[int(l) % len(_COLORS)]
        )
        cv2.circle(c1, (int(p[0]), int(p[1])), radius, col, -1)
        cv2.circle(c2, (int(q[0]), int(q[1])), radius, col, -1)
    h = max(c1.shape[0], c2.shape[0])

    def pad(c):
        return np.pad(c, ((0, h - c.shape[0]), (0, 0), (0, 0)),
                      constant_values=255)

    return np.concatenate([pad(c1), pad(c2)], axis=1)


def save_labels_figure(path, x1, x2, labels, outlier_label,
                       img1=None, img2=None):
    """Write draw_labels' image to `path` (cv2.imwrite); returns path."""
    import cv2

    img = draw_labels(x1, x2, labels, outlier_label, img1, img2)
    cv2.imwrite(path, img)
    return path
