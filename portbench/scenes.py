"""Stand-in scenes for the AdelaideRMF pairs, made from the run's seed.

`plane_scene` and `motion_scene` are frozen NumPy copies of the port's
`synthetic_scene` and `synthetic_motion_scene` (multih_tpu_torch/utils/
data.py): the benchmark keeps its own so that a change to the program
cannot change the inputs it is measured on. The tests hold the copies
equal to the originals on a few seeds.

`make_pool` builds a configuration's pool of distinct pairs. The pool's
sizes are a fixed grid over the configuration's ranges (every seed gets
the same set of point counts, model counts, outlier shares and noise
levels); the seed picks each scene's geometry and the order of the pool.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Scene(NamedTuple):
    x1: np.ndarray      # (n, 2) float32
    x2: np.ndarray      # (n, 2) float32
    gt: np.ndarray      # (n,) int32, 0 = outlier, 1..P = models
    models: np.ndarray  # (P, 3, 3) float32 true homographies / F's


def _random_homography(rng: np.random.Generator, scale: float = 640.0):
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


def plane_scene(n_points, n_planes, outlier_rate, noise_px, seed,
                image_size=640.0, clustered=True, overlap=0.0) -> Scene:
    """Multi-plane stereo pair with known truth (copy of the port's
    `synthetic_scene`)."""
    rng = np.random.default_rng(seed)
    n_out = int(round(n_points * outlier_rate))
    n_in = n_points - n_out
    counts = np.full(n_planes, n_in // n_planes)
    counts[: n_in - counts.sum()] += 1

    Hs = np.stack([_random_homography(rng, image_size)
                   for _ in range(n_planes)])

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
    return Scene(x1[perm], x2[perm], lab[perm], Hs.astype(np.float32))


def _unit(v: np.ndarray) -> np.ndarray:
    return v / (np.linalg.norm(v) + 1e-12)


def motion_scene(n_points, n_motions, outlier_rate, noise_px, seed,
                 image_size=640.0) -> Scene:
    """Multi-motion two-view pair with known truth (copy of the port's
    `synthetic_motion_scene`)."""
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
    return Scene(x1[perm], x2[perm], lab[perm], np.stack(Fs).astype(
        np.float32))


GENERATORS = {"plane": plane_scene, "motion": motion_scene}


def _grid(lo: float, hi: float, k: int, i: int) -> float:
    """The i-th of k evenly spaced levels over [lo, hi]."""
    return lo if k == 1 else lo + (hi - lo) * i / (k - 1)


def pool_sizes(spec: dict, pool: int) -> list[tuple]:
    """The pool's (n_points, n_models, outlier_rate, noise_px) rows: a
    fixed stratified grid over the spec's ranges (the same for every
    seed). Entry i takes level i of the point counts and model counts,
    and levels shifted by coprime strides of the outlier share and noise,
    so the four ranges are covered jointly, not in lockstep."""
    (n_lo, n_hi), (m_lo, m_hi) = spec["n_points"], spec["n_models"]
    (o_lo, o_hi), (s_lo, s_hi) = spec["outlier_rate"], spec["noise_px"]
    n_models = m_hi - m_lo + 1
    rows = []
    for i in range(pool):
        rows.append((
            int(round(_grid(n_lo, n_hi, pool, i))),
            m_lo + (i % n_models),
            round(_grid(o_lo, o_hi, 5, (3 * i) % 5), 6),
            round(_grid(s_lo, s_hi, 4, (5 * i + 1) % 4), 6),
        ))
    return rows


def make_pool(spec: dict, pool: int, seed: int) -> list[Scene]:
    """`pool` distinct scenes of a configuration's `scenes` spec
    (generator and ranges), their geometry and order drawn from `seed`."""
    gen = GENERATORS[spec["generator"]]
    rng = np.random.default_rng([seed & (2**64 - 1), 0x5CE7E])
    rows = pool_sizes(spec, pool)
    order = rng.permutation(pool)
    seeds = rng.integers(0, 2**31 - 1, pool)
    return [gen(*rows[j], int(seeds[i])) for i, j in enumerate(order)]


def pad(scene: Scene, max_points: int):
    """(x1, x2, valid) padded to max_points (float32), and the truth
    padded with -1."""
    n = scene.x1.shape[0]
    x1 = np.zeros((max_points, 2), np.float32)
    x2 = np.zeros((max_points, 2), np.float32)
    valid = np.zeros((max_points,), np.float32)
    gt = np.full((max_points,), -1, np.int32)
    x1[:n], x2[:n], valid[:n], gt[:n] = scene.x1, scene.x2, 1.0, scene.gt
    return x1, x2, valid, gt
