"""The port's fundamental (multi-motion) model against the JAX package.

Same numpy inputs (seeded) through the JAX function, called eagerly, and
its port: the epipolar residuals, the 8- and 12-point solvers, the
36-moment refit, K1's epipolar kinds (plain version vs the Pallas kernel
in interpret mode), coverage selection and the motion scene generator.
Then one F fit on replayed draws: the motion suite's config at its
512-point bucket (the config of tests/test_fmodel_pipeline.py, so the
persistent compile cache serves both), compiled once, two keys on fm4_a.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multih_tpu
from benchmarks import suite
from multih_tpu.models import selection as jsel
from multih_tpu.ops import fmodel as jfm
from multih_tpu.ops.kernels import residual_kernel as jres
from multih_tpu.utils import data as jdata

import multih_tpu_torch as mt
from multih_tpu_torch.models import selection as tsel
from multih_tpu_torch.ops import fmodel as tfm
from multih_tpu_torch.ops.kernels import eig_kernel as teig
from multih_tpu_torch.ops.kernels import residual_kernel as tres
from multih_tpu_torch.utils import data as tdata
from multih_tpu_torch.utils import evaluation
from test_torch_ops import KeyDraws
from test_torch_kernels import (eigvec_err64, eigvec_floor, f_normal_matrices,
                                member_weights, random_fs, t)

F_CFG = dict(max_points=512, n_hypotheses=2048, model="fundamental",
             residual="sampson", inlier_threshold=3.0)
FIT_SEEDS = (0, 1)
# measured label agreement with the JAX fit on fm4_a (replayed draws):
# key 0 every label; key 1 98.63%, because the JAX fit's whole-program
# compile rounds the hypothesis pool differently from the same stage
# run alone (1914 vs 1905 finite hypotheses; the port matches the
# latter), and the fits then part at PEARL
FIT_AGREEMENT = {0: 100.0, 1: 97.0}


def motion_samples(rng, s, m, name="fm4_a"):
    """(S, m, 2) x2 point samples, each m distinct points of one motion of
    a suite scene (noise 0.5 px), as minimal / member subsets are."""
    cs = tdata.motion_suite_scene(name)
    p1 = np.empty((s, m, 2), np.float32)
    p2 = np.empty((s, m, 2), np.float32)
    motions = np.unique(cs.gt_labels[cs.gt_labels > 0])
    for i in range(s):
        ids = np.flatnonzero(cs.gt_labels == rng.choice(motions))
        pick = rng.choice(ids, m, replace=False)
        p1[i], p2[i] = cs.x1[pick], cs.x2[pick]
    return p1, p2


def _j(a):
    return jnp.asarray(np.asarray(a))


# ---------------------------------------------------------------------------
# residuals, solvers, refit
# ---------------------------------------------------------------------------

def cancellation_floor(Fs, x1, x2, kind):
    """(S, N) float32 floor of an epipolar residual, in float64: the
    constraint value e = x2h . F x1h is a sum of terms far larger than
    itself near an epiline, so one float32 ulp of its term scale
    |x2h|^T |F| |x1h| is the least error any float32 order of summation
    has; r = e^2 / den moves by 2 |e| de + de^2 over den."""
    F = Fs.astype(np.float64)
    a = np.c_[x1, np.ones(len(x1))].astype(np.float64)
    b = np.c_[x2, np.ones(len(x2))].astype(np.float64)
    l = np.einsum("sij,nj->sni", F, a)
    m = np.einsum("sji,nj->sni", F, b)
    e = np.einsum("ni,sni->sn", b, l)
    de = np.finfo(np.float32).eps * np.einsum(
        "ni,sni->sn", np.abs(b), np.einsum("sij,nj->sni", np.abs(F),
                                          np.abs(a)))
    dl = l[..., 0] ** 2 + l[..., 1] ** 2
    dm = m[..., 0] ** 2 + m[..., 1] ** 2
    den = {"sampson": dl + dm, "transfer": dl,
           "symmetric": 1.0 / (1.0 / dl + 1.0 / dm)}[kind]
    return (2.0 * np.abs(e) * de + de * de) / den


@pytest.mark.parametrize("kind", ["sampson", "symmetric", "transfer"])
def test_residual_matrix_f(rng, kind):
    """rtol 1e-5, plus the float32 cancellation floor of e where an
    epiline passes near the point (a quarter of these entries; there
    the JAX residual itself is up to 3.3e-3 from float64, measured)."""
    Fs = random_fs(rng, 64)
    x1 = rng.uniform(0, 640, (300, 2)).astype(np.float32)
    x2 = rng.uniform(0, 640, (300, 2)).astype(np.float32)
    ref = np.asarray(jfm.residual_matrix_f(_j(Fs), _j(x1), _j(x2), kind))
    got = tfm.residual_matrix_f(t(Fs), t(x1), t(x2), kind).numpy()
    tol = 1e-5 * np.abs(ref) + cancellation_floor(Fs, x1, x2, kind)
    assert (np.abs(got.astype(np.float64) - ref) <= tol).all()


def _ill_conditioned(solve, p1, p2, *f32s):
    """Samples where a float32 solve (`f32s`) is more than 1e-4 from the
    float64 one: there no float32 solver holds 5e-4 (the rule of
    chip_smoke.dlt_parity)."""
    f64 = solve(t(p1).double(), t(p2).double()).numpy()
    return np.any([np.abs(f - f64).max((1, 2)) > 1e-4 for f in f32s], 0)


@pytest.mark.parametrize("m", [8, 12])
def test_minimal_solvers(m):
    """8-point (Givens-QR nullspace behind _Q0) and 12-point (normal
    equations + eigh) solves of one-motion samples, canonical F's within
    5e-4 of the JAX package's on the well-conditioned samples, those
    where both float32 solves are within 1e-4 of the float64 one.
    Measured ill-conditioned share on fm4_a's motions (0.5 px noise, of
    512): 8-point 1.2% (6), 12-point 7.2% (37; the normal equations
    square the condition number, and the two packages' float32 eigh part
    by up to 0.075 there)."""
    rng = np.random.default_rng(8 + m)
    p1, p2 = motion_samples(rng, 512, m)
    if m == 8:
        jsolve = jax.jit(jfm.fundamental_8pt_batch_qr)
        tsolve = tfm.fundamental_8pt_batch_qr
    else:
        jsolve = jax.jit(lambda a, b: jfm.fundamental_npt_batch(
            a, b, 6, "eigh"))

        def tsolve(a, b):
            return tfm.fundamental_npt_batch(a, b, 6, "eigh")
    ref = np.asarray(jsolve(_j(p1), _j(p2)))
    got = tsolve(t(p1), t(p2)).numpy()
    ill = _ill_conditioned(tsolve, p1, p2, got, ref)
    err = np.abs(got - ref).max((1, 2))
    assert err[~ill].max() < 5e-4, err[~ill].max()
    assert ill.mean() < (0.03 if m == 8 else 0.12), ill.mean()
    # canonical form and rank 2 on every sample
    np.testing.assert_allclose(np.linalg.norm(got, axis=(1, 2)), 1.0,
                               atol=1e-5)
    assert np.abs(np.linalg.det(got.astype(np.float64))).max() < 1e-5
    flat = got.reshape(-1, 9)
    assert (flat[np.arange(len(flat)), np.abs(flat).argmax(1)] > 0).all()


def test_prepare_refit_f():
    cs = tdata.motion_suite_scene("fm2_b")
    jb = jfm.prepare_refit_f(_j(cs.x1), _j(cs.x2))
    tb = tfm.prepare_refit_f(t(cs.x1), t(cs.x2))
    for a, b in zip(jb, tb):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


def test_fundamental_refit_batch():
    """The 36-moment refit of member subsets: within 2e-3 of the JAX
    package (the homography path's end-to-end tolerance), rank 2, and
    both packages within the float32 floor of the float64 refit."""
    rng = np.random.default_rng(3)
    cs, w = member_weights(rng, 64)
    jb = jfm.prepare_refit_f(_j(cs.x1), _j(cs.x2))
    ref = np.asarray(jfm.fundamental_refit_batch(_j(w), jb, "eigh"))
    tb = tfm.prepare_refit_f(t(cs.x1), t(cs.x2))
    got = tfm.fundamental_refit_batch(t(w), tb, "eigh").numpy()
    assert np.abs(got - ref).max() < 2e-3
    b64 = tfm.prepare_refit_f(t(cs.x1).double(), t(cs.x2).double())
    f64 = tfm.fundamental_refit_batch(t(w).double(), b64, "eigh").numpy()
    for f in (got, ref):
        assert np.abs(f - f64).max() < 2e-3
        dets = np.abs(np.linalg.det(f.astype(np.float64)))
        assert dets.max() < 1e-6, dets.max()


def test_eig_plain_on_f_normal_matrices():
    """K3's plain version (6 Jacobi sweeps, the kernel's arithmetic) on
    F normal matrices of real member subsets, C=256: within 1e-3 of
    float64 eigh, sign-aligned, and within the first-order float32 floor
    eps32 * lam_max / gap on every matrix (measured 1.4e-4, a quarter of
    the floor at most; the smallest eigenvalue gap is down to 6e-5 of
    the largest)."""
    atas = f_normal_matrices(np.random.default_rng(4), 256)
    err = eigvec_err64(atas, teig.smallest_eigvec_9x9_batch_reference(atas))
    assert err.max() < 1e-3
    assert (err <= eigvec_floor(atas)).all()


# ---------------------------------------------------------------------------
# K1's epipolar kinds, coverage selection, scenes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["f_sampson", "f_symmetric", "f_transfer"])
def test_count_plain_matches_pallas_kernel(rng, kind):
    """The count kernel's plain version against the Pallas kernel in
    interpret mode, exact division (test_pallas_kernels.py:102):
    max |dcount| <= 2, mean < 0.5."""
    Fs = random_fs(rng, 128)
    x1 = rng.uniform(0, 640, (1024, 2)).astype(np.float32)
    x2 = rng.uniform(0, 640, (1024, 2)).astype(np.float32)
    valid = (rng.uniform(size=1024) > 0.2).astype(np.float32)
    ref = np.asarray(jres.inlier_counts_padded(
        _j(Fs), _j(x1), _j(x2), _j(valid), jnp.float32(900.0),
        hyp_tile=64, pt_tile=512, interpret=True, approx_rcp=False,
        kind=kind))
    got = tres.inlier_counts_padded(t(Fs), t(x1), t(x2), t(valid),
                                    torch.tensor(900.0), kind=kind).numpy()
    d = np.abs(got - ref)
    assert ref.max() > 0 and d.max() <= 2.0 and d.mean() < 0.5


def test_select_candidates_coverage_equal(rng):
    """Greedy marginal coverage, exact: the same picks and slots."""
    s, n = 96, 400
    r = rng.uniform(0, 20, (s, n)).astype(np.float32)
    valid = (rng.uniform(size=n) > 0.1).astype(np.float32)
    ok = (rng.uniform(size=s) > 0.2).astype(np.float32)
    ji, ja = jsel.select_candidates_coverage(
        _j(r), _j(valid), jnp.float32(9.0), _j(ok), 48, 12, min_gain=10.0)
    ti, ta = tsel.select_candidates_coverage(
        t(r), t(valid), torch.tensor(9.0), t(ok), 48, 12, min_gain=10.0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert 0 < ta.sum() < 12


@pytest.mark.parametrize("row", suite.MOTION_SUITE, ids=lambda r: r[0])
def test_synthetic_motion_scene_byte_equal(row):
    name, n, motions, outl, noise, seed = row
    a, fa = jdata.synthetic_motion_scene(n, motions, outl, noise, seed=seed)
    b, fb = tdata.synthetic_motion_scene(n, motions, outl, noise, seed=seed)
    for x, y in ((a.x1, b.x1), (a.x2, b.x2), (a.gt_labels, b.gt_labels),
                 (fa, fb)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert tuple(row) in [tuple(r) for r in tdata.MOTION_SUITE]
    assert tdata.motion_suite_scene(name).name == name


def test_motion_suite_rows_are_the_suite_rows():
    assert [tuple(r) for r in tdata.MOTION_SUITE] == \
        [tuple(r) for r in suite.MOTION_SUITE]


def test_fundamental_config_carries_across():
    jcfg = multih_tpu.MultiHConfig(f_sample_points=12, **F_CFG)
    tcfg = mt.MultiHConfig.from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.minimal_points == jcfg.minimal_points == 8
    assert tcfg.lo_shrink_eff == jcfg.lo_shrink_eff == 1.0


# ---------------------------------------------------------------------------
# one F fit on replayed draws
# ---------------------------------------------------------------------------

class FitReplayDrawsF(KeyDraws):
    """Replays `multih_tpu.fit`'s draws for `key` on the fundamental
    model: the progressive round `r` splits into the uniform half's key
    and the localized half's, which splits again into the two clusters'
    (streams ("loc_a", r), ("loc_b", r); pipeline.py:175, :185); the
    member-resample Gumbel noise of iteration `it` (stream ("resample",
    it)) comes from fold_in(fold_in(key', 0x7e5a), it), key' the first
    of fit's three-way split (pipeline.py:1174, :1631, :1691)."""

    def __init__(self, key, rounds):
        key2, k_gen, _ = jax.random.split(key, 3)
        self.round_keys = jax.random.split(k_gen, rounds)
        self.key_x = jax.random.fold_in(key2, 0x7e5a)

    def keys(self, stream):
        if isinstance(stream, tuple):
            half, r = stream
            k_u, k_l = jax.random.split(self.round_keys[r])
            k_a, k_b = jax.random.split(k_l)
            return k_u, (k_a if half == "loc_a" else k_b)
        k_u, k_l = jax.random.split(self.round_keys[stream])
        return k_u, k_l

    def gumbel(self, stream, shape, device):
        if isinstance(stream, tuple) and stream[0] == "resample":
            return t(np.array(jax.random.gumbel(
                jax.random.fold_in(self.key_x, stream[1]), shape,
                dtype=jnp.float32)))
        return super().gumbel(stream, shape, device)


@pytest.fixture(scope="module")
def f_fits():
    """(JAX result, port result) per key on fm4_a, one JAX compile."""
    jcfg = multih_tpu.MultiHConfig(**F_CFG)
    tcfg = mt.MultiHConfig.from_dict(dataclasses.asdict(jcfg))
    jf = multih_tpu.make_fit(jcfg)
    cs = tdata.motion_suite_scene("fm4_a")
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 512)
    out = {}
    for seed in FIT_SEEDS:
        key = jax.random.key(seed)
        jr = jax.device_get(jf(x1, x2, valid, key))
        tr = mt.fit(x1, x2, valid,
                    FitReplayDrawsF(key, jcfg.progressive_rounds), tcfg,
                    device="cpu")
        out[seed] = (jr, tr, gt)
    return out


@pytest.mark.parametrize("seed", FIT_SEEDS)
def test_f_fit_matches_reference(f_fits, seed):
    """Motion count exact; label agreement with the JAX fit at least
    the measured FIT_AGREEMENT (every label on key 0; >= 97%, the golden
    per-point bar, on key 1); both fits recover the scene."""
    jr, tr, gt = f_fits[seed]
    assert int(tr.active.sum()) == int(np.asarray(jr.active).sum()) == 4
    agree = 100.0 - evaluation.misclassification_error(
        tr.labels.numpy(), np.asarray(jr.labels), 16, gt_outlier=16)
    assert agree >= FIT_AGREEMENT[seed], agree
    assert evaluation.misclassification_error(tr.labels.numpy(), gt,
                                              16) < 3.0
    assert tr.energy_trace.shape == np.asarray(jr.energy_trace).shape == (12,)


def test_f_fit_fundamentals_match_reference(f_fits):
    """On key 0, where every label agrees: energies within 1e-3 and
    matched F's (canonical form) within 2e-3, the refit tolerance of
    the homography path."""
    jr, tr, _ = f_fits[0]
    np.testing.assert_allclose(float(tr.energy), float(jr.energy),
                               rtol=1e-3)
    assert float(tr.n_hypotheses_ok) == float(jr.n_hypotheses_ok)
    mapping = evaluation.match_labels(tr.labels.numpy(),
                                      np.asarray(jr.labels), 16, 16)
    pairs = {p: q for p, q in mapping.items() if p != 16 and q != 16}
    assert len(pairs) == 4
    jf_, tf_ = np.asarray(jr.homographies), tr.homographies.numpy()
    for p, q in pairs.items():
        assert np.abs(tf_[p] - jf_[q]).max() < 2e-3, (p, q)
