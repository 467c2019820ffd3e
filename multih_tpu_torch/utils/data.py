"""Correspondence files and synthetic scenes for the port (numpy and
scipy only).

Byte-for-byte copies of ``multih_tpu.utils.data``'s file readers and
writer, its plane, motion and mixed scene generators and of
``benchmarks/suite.py``'s scene tables: those modules cannot be imported
without JAX (``multih_tpu/__init__.py`` imports it), and the machine
with the card has no JAX. The parity tests assert both generators give
identical arrays and the tables equal rows.
"""

from __future__ import annotations

import os
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


def load_adelaide_mat(path: str) -> CorrespondenceSet:
    """AdelaideRMF .mat: 'data' is 6xN ([x;y;1;x';y';1]), 'label' is N."""
    from scipy.io import loadmat

    m = loadmat(path)
    data = m["data"]
    if data.shape[0] != 6:
        data = data.T
    x1 = (data[0:2] / data[2:3]).T.astype(np.float32)
    x2 = (data[3:5] / data[5:6]).T.astype(np.float32)
    label = None
    if "label" in m:
        label = np.asarray(m["label"]).reshape(-1).astype(np.int32)
    name = os.path.splitext(os.path.basename(path))[0]
    return CorrespondenceSet(x1, x2, label, name)


def load_correspondences_txt(path: str) -> CorrespondenceSet:
    """Whitespace table: x y x' y' [gt_label], one correspondence per row."""
    arr = np.loadtxt(path, dtype=np.float64, ndmin=2)
    x1 = arr[:, 0:2].astype(np.float32)
    x2 = arr[:, 2:4].astype(np.float32)
    label = (
        arr[:, 4].astype(np.int32) if arr.shape[1] > 4 else None
    )
    name = os.path.splitext(os.path.basename(path))[0]
    return CorrespondenceSet(x1, x2, label, name)


def save_correspondences_txt(path: str, cs: CorrespondenceSet) -> None:
    cols = [cs.x1, cs.x2]
    if cs.gt_labels is not None:
        cols.append(cs.gt_labels[:, None].astype(np.float32))
    np.savetxt(path, np.concatenate(cols, axis=1), fmt="%.6f")


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


def _unit(v: np.ndarray) -> np.ndarray:
    return v / (np.linalg.norm(v) + 1e-12)


def synthetic_motion_scene(
    n_points: int = 1000,
    n_motions: int = 2,
    outlier_rate: float = 0.0,
    noise_px: float = 0.0,
    seed: int = 0,
    image_size: float = 640.0,
) -> tuple[CorrespondenceSet, np.ndarray]:
    """Multi-motion two-view scene with known GT (labels: 0 = outlier,
    1..M = motions): each motion a compact 3D blob under its own rigid
    transform, seen by one calibrated camera pair. Returns
    (CorrespondenceSet, (M, 3, 3) true fundamental matrices, Frobenius-
    normalized). See ``multih_tpu.utils.data.synthetic_motion_scene``."""
    rng = np.random.default_rng(seed)
    f_len = 1.25 * image_size
    K = np.array([
        [f_len, 0.0, image_size / 2.0],
        [0.0, f_len, image_size / 2.0],
        [0.0, 0.0, 1.0],
    ])
    K_inv = np.linalg.inv(K)

    n_out = int(round(n_points * outlier_rate))
    n_in = n_points - n_out
    counts = np.full(n_motions, n_in // n_motions)
    counts[: n_in - counts.sum()] += 1

    def rodrigues(a):
        t = np.linalg.norm(a) + 1e-12
        k = a / t
        Kx = np.array([
            [0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]
        ])
        return np.eye(3) + np.sin(t) * Kx + (1 - np.cos(t)) * Kx @ Kx

    Fs, x1_list, x2_list, lab_list = [], [], [], []
    for m in range(n_motions):
        c = counts[m]
        cx = rng.uniform(-1.5, 1.5)
        cy = rng.uniform(-1.5, 1.5)
        cz = rng.uniform(5.0, 9.0)
        X = np.array([cx, cy, cz]) + rng.normal(0, 0.8, (c, 3))
        X[:, 2] = np.clip(X[:, 2], 2.0, None)
        R = rodrigues(np.deg2rad(rng.uniform(4.0, 12.0))
                      * _unit(rng.normal(size=3)))
        t = rng.uniform(0.4, 1.2) * _unit(rng.normal(size=3))
        Y = X @ R.T + t
        Y[:, 2] = np.clip(Y[:, 2], 1.0, None)
        p1 = (X @ K.T)
        p1 = p1[:, :2] / p1[:, 2:3]
        p2 = (Y @ K.T)
        p2 = p2[:, :2] / p2[:, 2:3]
        if noise_px > 0:
            p1 = p1 + rng.normal(0, noise_px, (c, 2))
            p2 = p2 + rng.normal(0, noise_px, (c, 2))
        tx = np.array([
            [0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]
        ])
        F = K_inv.T @ tx @ R @ K_inv
        Fs.append(F / np.linalg.norm(F))
        x1_list.append(p1)
        x2_list.append(p2)
        lab_list.append(np.full(c, m + 1))

    if n_out:
        x1_list.append(rng.uniform(0, image_size, (n_out, 2)))
        x2_list.append(rng.uniform(0, image_size, (n_out, 2)))
        lab_list.append(np.zeros(n_out))

    x1 = np.concatenate(x1_list).astype(np.float32)
    x2 = np.concatenate(x2_list).astype(np.float32)
    lab = np.concatenate(lab_list).astype(np.int32)
    perm = rng.permutation(x1.shape[0])
    cs = CorrespondenceSet(
        x1[perm], x2[perm], lab[perm],
        f"synthetic_motion_m{n_motions}_s{seed}",
    )
    return cs, np.stack(Fs).astype(np.float32)


# benchmarks/suite.py's MOTION_SUITE (frozen rows; the parity tests
# assert they are equal): name, n_points, n_motions, outlier_rate,
# noise_px, seed. The golden labelings tests/goldens/fm*.npz belong to
# these scenes (model="fundamental", residual="sampson", tau 3).
MOTION_SUITE = [
    ("fm2_a", 400, 2, 0.10, 0.0, 201),
    ("fm2_b", 400, 2, 0.15, 0.5, 202),
    ("fm3_a", 400, 3, 0.20, 0.5, 203),
    ("fm3_b", 500, 3, 0.30, 0.5, 204),
    ("fm4_a", 400, 4, 0.10, 0.5, 205),
    ("fm4_b", 600, 4, 0.15, 0.5, 216),
    ("fm5_a", 700, 5, 0.15, 0.3, 220),
    ("fm_out40", 500, 3, 0.40, 0.5, 208),
    ("fm_out40b", 500, 3, 0.40, 0.5, 218),
]


def motion_suite_scene(name: str) -> CorrespondenceSet:
    """Materialize one MOTION_SUITE row, named as in benchmarks/suite.py."""
    for row_name, n, motions, outl, noise, seed in MOTION_SUITE:
        if row_name == name:
            cs, _ = synthetic_motion_scene(
                n_points=n, n_motions=motions, outlier_rate=outl,
                noise_px=noise, seed=seed,
            )
            return cs._replace(name=name)
    raise KeyError(name)


def synthetic_mixed_scene(
    n_points: int = 600,
    n_planes: int = 2,
    n_motions: int = 1,
    outlier_rate: float = 0.1,
    noise_px: float = 0.0,
    seed: int = 0,
    image_size: float = 640.0,
) -> tuple[CorrespondenceSet, np.ndarray, np.ndarray]:
    """Mixed plane + motion two-view scene with known GT — the fixture of
    the mixed multi-class fit (models/mixed.py): planar structures (each
    an independent random homography region, as `synthetic_scene`) and
    independently moving non-planar rigid bodies (3D blobs under their
    own (R, t), as `synthetic_motion_scene`) in ONE correspondence set.

    GT label convention: 0 = outlier, 1..P = planes,
    P+1..P+M = motions. Points are split evenly between the plane and
    motion halves (then evenly within each half).

    Returns (CorrespondenceSet, (P, 3, 3) true homographies,
    (M, 3, 3) true fundamental matrices)."""
    rng = np.random.default_rng(seed)
    n_out = int(round(n_points * outlier_rate))
    n_in = n_points - n_out
    if n_planes == 0:
        n_h, n_f = 0, n_in          # pure-motion scene: no plane half
    elif n_motions == 0:
        n_h, n_f = n_in, 0          # pure-plane scene: no motion half
    else:
        n_h = n_in // 2
        n_f = n_in - n_h

    parts_x1, parts_x2, parts_lab = [], [], []
    if n_planes > 0:
        cs_h, Hs = synthetic_scene(
            n_h, n_planes, 0.0, noise_px, seed=seed * 7919 + 1,
            image_size=image_size,
        )
        parts_x1.append(cs_h.x1)
        parts_x2.append(cs_h.x2)
        parts_lab.append(cs_h.gt_labels)
    else:
        Hs = np.zeros((0, 3, 3), np.float32)
    if n_motions > 0:
        cs_f, Fs = synthetic_motion_scene(
            n_f, n_motions, 0.0, noise_px, seed=seed * 7919 + 2,
            image_size=image_size,
        )
        parts_x1.append(cs_f.x1)
        parts_x2.append(cs_f.x2)
        parts_lab.append(
            np.where(cs_f.gt_labels > 0, cs_f.gt_labels + n_planes, 0)
        )
    else:
        Fs = np.zeros((0, 3, 3), np.float32)
    if n_out:
        parts_x1.append(
            rng.uniform(0, image_size, (n_out, 2)).astype(np.float32)
        )
        parts_x2.append(
            rng.uniform(0, image_size, (n_out, 2)).astype(np.float32)
        )
        parts_lab.append(np.zeros(n_out, np.int32))

    x1 = np.concatenate(parts_x1).astype(np.float32)
    x2 = np.concatenate(parts_x2).astype(np.float32)
    lab = np.concatenate(parts_lab).astype(np.int32)
    perm = rng.permutation(x1.shape[0])
    cs = CorrespondenceSet(
        x1[perm], x2[perm], lab[perm],
        f"synthetic_mixed_p{n_planes}_m{n_motions}_s{seed}",
    )
    return cs, Hs, Fs


# benchmarks/suite.py's MIXED_SUITE (frozen rows; the parity tests assert
# they are equal): name, n_points, n_planes, n_motions, outlier_rate,
# noise_px, seed. The golden labelings tests/goldens/mx*.npz belong to
# these scenes (models/mixed.py's defaults, tau 3 for both classes).
MIXED_SUITE = [
    ("mx21_a", 600, 2, 1, 0.10, 0.5, 301),
    ("mx12_a", 600, 1, 2, 0.15, 0.5, 312),
    ("mx22_a", 700, 2, 2, 0.10, 0.5, 303),
    ("mx22_b", 700, 2, 2, 0.30, 0.5, 324),
    ("mx03_a", 500, 0, 3, 0.15, 0.5, 307),   # pure-motion edge
    ("mx30_a", 500, 3, 0, 0.15, 0.5, 305),   # pure-plane edge
]


def mixed_scenes():
    """Materialize the mixed suite: list of (CorrespondenceSet, Hs, Fs)."""
    out = []
    for name, n, planes, motions, outl, noise, seed in MIXED_SUITE:
        cs, Hs, Fs = synthetic_mixed_scene(
            n_points=n, n_planes=planes, n_motions=motions,
            outlier_rate=outl, noise_px=noise, seed=seed,
        )
        cs = cs._replace(name=name)
        out.append((cs, Hs, Fs))
    return out


def mixed_suite_scene(name: str) -> CorrespondenceSet:
    """Materialize one MIXED_SUITE row, named as in benchmarks/suite.py."""
    for row_name, n, planes, motions, outl, noise, seed in MIXED_SUITE:
        if row_name == name:
            cs, _, _ = synthetic_mixed_scene(
                n_points=n, n_planes=planes, n_motions=motions,
                outlier_rate=outl, noise_px=noise, seed=seed,
            )
            return cs._replace(name=name)
    raise KeyError(name)
