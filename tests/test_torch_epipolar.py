"""The port's ops/epipolar.py, geometry.homography_from_points and
utils/features.affines_from_homographies against the JAX package.

Same numpy inputs (seeded) through the JAX function (eager, or jitted at
a small size) and its port. Float32 floors are measured against float64
runs of the port. `estimate_fundamental` draws its samples through a
source that replays the JAX key's threefry draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multih_tpu.ops import epipolar as jepi
from multih_tpu.ops import geometry as jgeo
from multih_tpu.utils import data as jdata
from multih_tpu.utils import features as jfeat

from multih_tpu_torch.ops import epipolar as tepi
from multih_tpu_torch.ops import geometry as tgeo
from multih_tpu_torch.ops.sampling import TorchDraws
from multih_tpu_torch.utils import features as tfeat
from test_torch_kernels import t
from test_torch_pipeline import JaxReplayDraws

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    """A 2-plane scene with ground-truth affine frames, its F (the
    reference's estimate) and its homographies."""
    cs, Hs = jdata.synthetic_scene(200, 2, 0.1, 0.3, seed=21)
    aff = jfeat.affines_from_homographies(Hs, cs.gt_labels - 1, cs.x1,
                                          outlier_label=-1)
    F = np.asarray(jepi.fundamental_8pt(jnp.asarray(cs.x1),
                                        jnp.asarray(cs.x2)))
    return cs, Hs, aff, F


def normalized_f(rng):
    """A random rank-2 F in normalized coordinates (order-1 entries)."""
    u, _, vt = np.linalg.svd(rng.normal(size=(3, 3)))
    F = u @ np.diag([1.0, rng.uniform(0.2, 0.9), 0.0]) @ vt
    return (F / np.linalg.norm(F)).astype(np.float32)


def test_f_rows(rng):
    x1 = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    x2 = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tepi._f_rows(t(x1), t(x2)).numpy(),
        np.asarray(jepi._f_rows(jnp.asarray(x1), jnp.asarray(x2))))


def test_fundamental_8pt_unweighted(scene):
    cs, _, _, F = scene
    got = tepi.fundamental_8pt(t(cs.x1), t(cs.x2)).numpy()
    assert np.abs(got - F).max() < 1e-5
    assert got[2, 2] >= 0
    assert abs(np.linalg.det(got.astype(np.float64))) < 1e-6


def test_fundamental_8pt_weighted_batch(scene, rng):
    """(C, N) weights on shared points: one batched solve, each row the
    JAX solve of that row."""
    cs = scene[0]
    w = rng.uniform(0, 1, (4, cs.n_points)).astype(np.float32)
    w[1, :100] = 0.0
    want = np.stack([np.asarray(jepi.fundamental_8pt(
        jnp.asarray(cs.x1), jnp.asarray(cs.x2), jnp.asarray(wi)))
        for wi in w])
    got = tepi.fundamental_8pt(t(cs.x1), t(cs.x2), t(w)).numpy()
    assert got.shape == (4, 3, 3)
    assert np.abs(got - want).max() < 1e-5


def two_view_scene(rng, n=100, noise=0.3):
    """Points in a depth range seen by two cameras (f = 600 px): a
    well-conditioned F (tests/test_epipolar.py's scene)."""
    from scipy.spatial.transform import Rotation

    pts = rng.uniform([-2, -2, 4], [2, 2, 8], (n, 3))
    K = np.array([[600, 0, 320], [0, 600, 240], [0, 0, 1.0]])
    R = Rotation.from_rotvec(rng.normal(0, 0.1, 3)).as_matrix()
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([R, rng.normal(0, 1, 3)[:, None]])

    def proj(P):
        y = np.hstack([pts, np.ones((n, 1))]) @ P.T
        return (y[:, :2] / y[:, 2:] + rng.normal(0, noise, (n, 2))).astype(
            np.float32)
    return proj(P1), proj(P2)


def test_fundamental_8pt_minimal_samples(rng):
    """(S, m, 2) samples, the batch estimate_fundamental solves. At the
    minimal m = 8 the 9x9 normal matrix is rank-deficient up to noise and
    float32 loses the null vector to ~0.01-0.06 of float64 (measured in
    JAX), so the port is held to the reference's own floor; at m = 12
    JAX sits within 1e-4 of float64 and the two within 1e-3 of each
    other. The port solves float32 input in float64 (3e-8 of it)."""
    x1, x2 = two_view_scene(rng)
    for m in (8, 12):
        idx = np.stack([rng.choice(x1.shape[0], m, replace=False)
                        for _ in range(32)])
        want = np.asarray(jax.vmap(jepi.fundamental_8pt)(
            jnp.asarray(x1[idx]), jnp.asarray(x2[idx])))
        got = tepi.fundamental_8pt(t(x1[idx]), t(x2[idx])).numpy()
        f64 = tepi.fundamental_8pt(t(x1[idx]).double(),
                                   t(x2[idx]).double()).numpy()
        assert got.shape == (32, 3, 3)
        floor = np.abs(want - f64).max()
        assert np.abs(got - f64).max() <= 1.5 * floor + 1e-5, m
        if m == 12:
            assert np.abs(got - want).max() < 1e-3


def sampson_floor64(Fs, x1, x2):
    """(float64 Sampson errors, float32's forward-error floor of each):
    S = num^2 / den with num = x2h^T F x1h, whose float32 rounding error
    is bounded by eps * T, T = |x2h|^T |F| |x1h|, so
    floor = eps * (2 |num| T / den + S)."""
    x1h = np.hstack([x1, np.ones((len(x1), 1))]).astype(np.float64)
    x2h = np.hstack([x2, np.ones((len(x2), 1))]).astype(np.float64)
    F = np.asarray(Fs, np.float64)
    fx1 = np.einsum("sij,nj->sni", F, x1h)
    ftx2 = np.einsum("sji,nj->sni", F, x2h)
    num = (x2h[None] * fx1).sum(-1)
    den = (fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2
           + ftx2[..., 1] ** 2)
    s64 = num ** 2 / den
    big_t = np.einsum("ni,sij,nj->sn", np.abs(x2h), np.abs(F), np.abs(x1h))
    eps = np.finfo(np.float32).eps
    return s64, eps * (2.0 * np.abs(num) * big_t / den + s64)


@pytest.mark.parametrize("seed", [21, 22, 23, 24])
def test_sampson_error_f(seed):
    """Against float64, within float32's forward-error floor of each
    point's error (`sampson_floor64`). Inliers' num cancels to ~1e-5 of
    its terms, so two float32 evaluations part by up to 1e-3 relative
    and which of them is nearer float64 depends on the CPU's products
    (measured over seeds 21-28: the port and JAX both within 0.6 of the
    floor)."""
    cs, _ = jdata.synthetic_scene(200, 2, 0.1, 0.3, seed=seed)
    F = np.asarray(jepi.fundamental_8pt(jnp.asarray(cs.x1),
                                        jnp.asarray(cs.x2)))
    Fs = np.stack([F, -F, F.T])
    want = np.asarray(jepi.sampson_error_f(jnp.asarray(Fs),
                                           jnp.asarray(cs.x1),
                                           jnp.asarray(cs.x2)))
    got = tepi.sampson_error_f(t(Fs), t(cs.x1), t(cs.x2)).numpy()
    assert got.shape == (3, cs.n_points)
    s64, floor = sampson_floor64(Fs, cs.x1, cs.x2)
    for s in (got, want):
        assert (np.abs(s - s64) <= floor).all()


@pytest.mark.parametrize("which", ["right", "left"])
def test_epipole(rng, which):
    """The null vector, up to the eigenvector's sign (which cancels in
    the one-point homography)."""
    F = normalized_f(rng)
    want = np.asarray(jepi.epipole(jnp.asarray(F), which))
    got = tepi.epipole(t(F), which).numpy()
    assert min(np.abs(got - want).max(), np.abs(got + want).max()) < 1e-5
    null = F.T @ got if which == "right" else F @ got
    assert np.linalg.norm(null) < 1e-5


def test_cross_mat(rng):
    e = rng.normal(size=3).astype(np.float32)
    np.testing.assert_array_equal(tepi._cross_mat(t(e)).numpy(),
                                  np.asarray(jepi._cross_mat(jnp.asarray(e))))
    v = rng.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(tepi._cross_mat(t(e)).numpy() @ v,
                               np.cross(e, v), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rank", [3, 2])
def test_lstsq_min_norm_matches_jnp(rng, rank):
    """The SVD solve is jnp.linalg.lstsq's: the least-squares solution,
    and on a rank-deficient system the minimum-norm one."""
    M = rng.normal(size=(6, 3)).astype(np.float32)
    if rank == 2:
        M[:, 2] = M[:, 0] + M[:, 1]
    b = rng.normal(size=6).astype(np.float32)
    want = np.asarray(jnp.linalg.lstsq(jnp.asarray(M), jnp.asarray(b))[0])
    got = tepi._lstsq_min_norm(t(M), t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_homography_one_point_single(rng):
    """One (point, affine) observation of a plane recovers its H
    (tests/test_epipolar.py's construction), and equals the JAX solve."""
    H = np.eye(3) + rng.normal(0, 0.08, (3, 3))
    H[2, :2] = rng.normal(0, 1e-4, 2)
    H /= np.linalg.norm(H)
    e2 = rng.normal(0, 1, 3)
    e2 /= np.linalg.norm(e2)
    F = np.cross(e2[:, None], H, axis=0)  # [e2]_x H
    F = (F / np.linalg.norm(F)).astype(np.float32)
    p1 = rng.uniform(100, 500, 2)
    y = H @ np.array([p1[0], p1[1], 1.0])
    p2 = y[:2] / y[2]
    A = np.zeros((2, 2))
    for j in range(2):
        d = np.zeros(2)
        d[j] = 0.25
        yp = H @ np.append(p1 + d, 1.0)
        ym = H @ np.append(p1 - d, 1.0)
        A[:, j] = (yp[:2] / yp[2] - ym[:2] / ym[2]) / 0.5
    args = [a.astype(np.float32) for a in (p1, p2, A)]
    got = tepi.homography_one_point(t(F), *map(t, args)).numpy()
    want = np.asarray(jepi.homography_one_point(
        jnp.asarray(F), *map(jnp.asarray, args)))
    H_ref = H * np.sign(H[2, 2])
    assert np.abs(got - H_ref).max() < 5e-3
    assert np.abs(got - want).max() < 1e-3


def test_homography_one_point_batch_float32_floor(scene):
    """One H a point from the scene's F: the port and the JAX package are
    each within float32's floor of the float64 solve (each ~8e-4 from it
    in Frobenius-normalized entries: the 6x3 system and the epipole's
    3x3 eigenproblem both square a condition number), and within 1e-3
    of each other."""
    cs, _, aff, F = scene
    want = np.asarray(jepi.homography_one_point_batch(
        jnp.asarray(F), jnp.asarray(cs.x1), jnp.asarray(cs.x2),
        jnp.asarray(aff)))
    got = tepi.homography_one_point_batch(t(F), t(cs.x1), t(cs.x2),
                                          t(aff)).numpy()
    h64 = tepi.homography_one_point_batch(
        t(F).double(), t(cs.x1).double(), t(cs.x2).double(),
        t(aff).double()).numpy()
    assert got.shape == (cs.n_points, 3, 3) and np.isfinite(got).all()
    assert (got[:, 2, 2] >= 0).all()
    for h in (got, want):
        assert np.abs(h - h64).max() < 1.5e-3
    assert np.abs(got - want).max() < 1e-3


def test_one_point_pool_recovers_planes(rng):
    """Two planes of one two-view geometry, H_p = K (R + t n_p^T) K^-1,
    and F = [K t]_x H_1: from F and its ground-truth affine frame, each
    point's one-point H is its own plane's (to float32's floor)."""
    from scipy.spatial.transform import Rotation

    K = np.array([[600, 0, 320], [0, 600, 240], [0, 0, 1.0]])
    R = Rotation.from_rotvec(rng.normal(0, 0.05, 3)).as_matrix()
    tv = rng.normal(0, 0.3, 3)
    Hs = []
    for n_p in (np.array([0.1, 0.0, -0.2]), np.array([-0.15, 0.1, -0.25])):
        H = K @ (R + np.outer(tv, n_p)) @ np.linalg.inv(K)
        Hs.append(H / np.linalg.norm(H) * np.sign(H[2, 2]))
    Hs = np.stack(Hs)
    labels = np.repeat([0, 1], 60)
    x1 = rng.uniform(50, 590, (120, 2))
    y = np.einsum("nij,nj->ni", Hs[labels], np.hstack([x1, np.ones((120, 1))]))
    x2 = (y[:, :2] / y[:, 2:]).astype(np.float32)
    x1 = x1.astype(np.float32)
    aff = tfeat.affines_from_homographies(Hs, labels, x1, -1)
    e2 = K @ tv
    F = np.cross(e2[:, None], Hs[0], axis=0)
    F = (F / np.linalg.norm(F)).astype(np.float32)
    got = tepi.homography_one_point_batch(t(F), t(x1), t(x2),
                                          t(aff)).numpy()
    assert np.abs(got - Hs[labels]).max() < 2e-3


def test_estimate_fundamental_replayed(rng):
    """The port on replayed draws picks the JAX estimate's sample and LO
    polish: the same F within float32 rounding, and inlier counts at its
    threshold equal."""
    cs, _ = jdata.synthetic_motion_scene(150, 1, 0.2, 0.5, seed=3)
    valid = np.ones(cs.n_points, np.float32)
    valid[-10:] = 0.0
    key = jax.random.key(4)
    k_f = jax.random.split(key, 3)[2]
    f_j = jax.jit(lambda k, a, b, v: jepi.estimate_fundamental(
        k, a, b, v, n_samples=64, threshold=1.0))
    want = np.asarray(f_j(k_f, cs.x1, cs.x2, valid))
    got = tepi.estimate_fundamental(JaxReplayDraws(key, 1), t(cs.x1),
                                    t(cs.x2), t(valid), n_samples=64,
                                    threshold=1.0).numpy()
    assert np.abs(got - want).max() < 1e-4

    def inliers(F):
        e = tepi.sampson_error_f(t(F), t(cs.x1), t(cs.x2)).numpy()
        return int(((e < 1.0) * valid).sum())
    # float32 rounding moves at most a boundary tie or two (the count
    # kernel's tolerance)
    assert abs(inliers(got) - inliers(want)) <= 2 and inliers(want) > 100


def test_estimate_fundamental_torch_draws():
    """With the port's own generator: an F that explains the motion."""
    cs, _ = jdata.synthetic_motion_scene(150, 1, 0.2, 0.5, seed=3)
    F = tepi.estimate_fundamental(
        TorchDraws(torch.Generator().manual_seed(0)), t(cs.x1), t(cs.x2),
        torch.ones(cs.n_points), n_samples=128)
    e = tepi.sampson_error_f(F, t(cs.x1), t(cs.x2)).numpy()
    inl = cs.gt_labels > 0
    assert np.median(e[inl]) < 1.0


@pytest.mark.parametrize("method", ["eigh", "inverse_iteration"])
def test_homography_from_points_batch(scene, rng, method):
    """(C, N) weight rows on shared points: one batched DLT, each row the
    JAX solve of that row."""
    cs = scene[0]
    w = rng.uniform(0, 1, (3, cs.n_points)).astype(np.float32)
    w[0] = (cs.gt_labels == 1)
    want = np.stack([np.asarray(jgeo.homography_from_points(
        jnp.asarray(cs.x1), jnp.asarray(cs.x2), jnp.asarray(wi), method, 8))
        for wi in w])
    got = tgeo.homography_from_points(t(cs.x1), t(cs.x2), t(w), method,
                                      8).numpy()
    assert got.shape == (3, 3, 3)
    assert np.abs(got - want).max() < 1e-4


def test_affines_from_homographies_byte_equal(scene):
    cs, Hs = scene[0], scene[1]
    a = jfeat.affines_from_homographies(Hs, cs.gt_labels - 1, cs.x1, -1)
    b = tfeat.affines_from_homographies(Hs, cs.gt_labels - 1, cs.x1, -1)
    assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    assert not np.array_equal(a[cs.gt_labels > 0][0], np.eye(2))
