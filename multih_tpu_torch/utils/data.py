"""Synthetic scenes for the port (numpy only).

Byte-for-byte copies of ``multih_tpu.utils.data``'s scene generator:
that module cannot be imported without JAX (``multih_tpu/__init__.py``
imports it), and the machine with the card has no JAX. The parity tests
assert both generators give identical arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CorrespondenceSet(NamedTuple):
    x1: np.ndarray          # (N, 2) float32 — keypoints in image 1
    x2: np.ndarray          # (N, 2) float32 — keypoints in image 2
    gt_labels: np.ndarray | None  # (N,) int32; 0 = outlier (AdelaideRMF)
    name: str

    @property
    def n_points(self) -> int:
        return self.x1.shape[0]

    @property
    def n_planes(self) -> int:
        if self.gt_labels is None:
            return 0
        return int(np.max(self.gt_labels))


def _random_homography(rng: np.random.Generator, scale: float = 640.0):
    """A well-conditioned random homography mapping roughly the image box to
    itself: random 3D plane seen by two nearby cameras."""
    angle = rng.uniform(-0.3, 0.3)
    s = rng.uniform(0.8, 1.25)
    tx, ty = rng.uniform(-0.15, 0.15, 2) * scale
    ca, sa = np.cos(angle), np.sin(angle)
    H = np.array(
        [
            [s * ca, -s * sa, tx],
            [s * sa, s * ca, ty],
            [
                rng.uniform(-0.3, 0.3) / scale,
                rng.uniform(-0.3, 0.3) / scale,
                1.0,
            ],
        ]
    )
    shear = np.eye(3)
    shear[0, 1] += rng.uniform(-0.15, 0.15)
    shear[1, 0] += rng.uniform(-0.15, 0.15)
    return H @ shear


def synthetic_scene(
    n_points: int = 1000,
    n_planes: int = 2,
    outlier_rate: float = 0.0,
    noise_px: float = 0.0,
    seed: int = 0,
    image_size: float = 640.0,
    clustered: bool = True,
    overlap: float = 0.0,
) -> tuple[CorrespondenceSet, np.ndarray]:
    """Multi-plane stereo scene with known GT (labels: 0 = outlier,
    1..P = planes). Returns (CorrespondenceSet, (P, 3, 3) true
    homographies). See ``multih_tpu.utils.data.synthetic_scene``."""
    rng = np.random.default_rng(seed)
    n_out = int(round(n_points * outlier_rate))
    n_in = n_points - n_out
    counts = np.full(n_planes, n_in // n_planes)
    counts[: n_in - counts.sum()] += 1

    Hs = np.stack([_random_homography(rng, image_size) for _ in range(n_planes)])

    x1_list, x2_list, lab_list = [], [], []
    g = int(np.ceil(np.sqrt(n_planes)))
    spacing = image_size / (g + 0.2)
    cells = [(i, j) for i in range(g) for j in range(g)]
    rng.shuffle(cells)
    centers = np.array(
        [
            (
                (ci + 0.6) * spacing + rng.uniform(-0.15, 0.15) * spacing,
                (cj + 0.6) * spacing + rng.uniform(-0.15, 0.15) * spacing,
            )
            for ci, cj in cells[:n_planes]
        ]
    )
    sigma = 0.30 * spacing
    if overlap > 0.0:
        mid = np.array([image_size / 2.0, image_size / 2.0])
        centers = mid + (centers - mid) * (1.0 - 0.65 * overlap)
        sigma = sigma * (1.0 + 1.5 * overlap)
    for p in range(n_planes):
        c = counts[p]
        if clustered:
            pts = centers[p] + rng.normal(0, sigma, (c, 2))
        else:
            pts = rng.uniform(0, image_size, (c, 2))
        pts = np.clip(pts, 0, image_size)
        ph = np.concatenate([pts, np.ones((c, 1))], axis=1)
        q = ph @ Hs[p].T
        q = q[:, :2] / q[:, 2:3]
        if noise_px > 0:
            pts = pts + rng.normal(0, noise_px, (c, 2))
            q = q + rng.normal(0, noise_px, (c, 2))
        x1_list.append(pts)
        x2_list.append(q)
        lab_list.append(np.full(c, p + 1))

    if n_out:
        x1_list.append(rng.uniform(0, image_size, (n_out, 2)))
        x2_list.append(rng.uniform(0, image_size, (n_out, 2)))
        lab_list.append(np.zeros(n_out))

    x1 = np.concatenate(x1_list).astype(np.float32)
    x2 = np.concatenate(x2_list).astype(np.float32)
    lab = np.concatenate(lab_list).astype(np.int32)
    perm = rng.permutation(x1.shape[0])
    cs = CorrespondenceSet(
        x1[perm], x2[perm], lab[perm], f"synthetic_p{n_planes}_s{seed}"
    )
    return cs, Hs.astype(np.float32)


# benchmarks/suite.py's homography SUITE (frozen rows; the parity tests
# assert they are equal): name, n_points, n_planes, outlier_rate,
# noise_px, seed, extra synthetic_scene kwargs. The golden labelings of
# tests/goldens/ belong to these scenes.
SUITE = [
    ("easy2_a", 300, 2, 0.05, 0.3, 101, {}),
    ("easy2_b", 450, 2, 0.10, 0.5, 102, {}),
    ("easy2_c", 240, 2, 0.00, 0.0, 103, {}),
    ("med3_a", 400, 3, 0.15, 0.5, 104, {}),
    ("med3_b", 500, 3, 0.20, 0.5, 105, {}),
    ("med3_c", 350, 3, 0.10, 0.7, 106, {}),
    ("med4_a", 480, 4, 0.15, 0.5, 107, {}),
    ("med4_b", 600, 4, 0.25, 0.5, 108, {}),
    ("hard5_a", 600, 5, 0.30, 0.5, 109, {}),
    ("hard5_b", 700, 5, 0.25, 0.7, 110, {}),
    ("hard6_a", 660, 6, 0.30, 0.5, 111, {}),
    ("hard7_a", 700, 7, 0.25, 0.5, 112, {}),
    ("outlier50_a", 500, 3, 0.50, 0.5, 113, {}),
    ("outlier50_b", 600, 4, 0.50, 0.5, 114, {}),
    ("small_a", 120, 2, 0.10, 0.3, 115, {}),
    ("small_b", 60, 1, 0.15, 0.3, 116, {}),
    ("noisy_a", 400, 3, 0.15, 1.0, 117, {}),
    ("noisy_b", 500, 4, 0.20, 1.0, 118, {}),
    ("single_a", 350, 1, 0.30, 0.5, 119, {}),
    ("overlap3_a", 450, 3, 0.15, 0.5, 122, {"overlap": 0.5}),
    ("overlap4_a", 520, 4, 0.20, 0.5, 123, {"overlap": 0.5}),
    ("overlap5_a", 600, 5, 0.25, 0.5, 124, {"overlap": 0.35}),
    ("inter3_a", 450, 3, 0.10, 0.5, 120, {"clustered": False}),
    ("inter4_a", 520, 4, 0.15, 0.5, 121, {"clustered": False}),
]


def suite_scene(name: str) -> CorrespondenceSet:
    """Materialize one SUITE row, named as in benchmarks/suite.py."""
    for row_name, n, planes, outl, noise, seed, kw in SUITE:
        if row_name == name:
            cs, _ = synthetic_scene(
                n_points=n, n_planes=planes, outlier_rate=outl,
                noise_px=noise, seed=seed, **kw,
            )
            return cs._replace(name=name)
    raise KeyError(name)
