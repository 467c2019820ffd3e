"""The port's fit, end to end, against the JAX fit on the slice config
MultiHConfig(knn_window=False, knn_approx=False) at a small size.

The port's fit takes a draw source that replays the JAX fit's own
threefry draws (following fit's key splits: pipeline.py:1174, :326,
:175; sampling.py:35, :79, :117), so both fits see the same minimal
samples. One JAX compile serves both scene seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multih_tpu
from multih_tpu.models import pipeline as jpipe

import multih_tpu_torch as mt
from multih_tpu_torch.models import pipeline as tpipe
from multih_tpu_torch.ops import geometry as tgeo
from multih_tpu_torch.parallel.mesh import Mesh
from multih_tpu_torch.utils import data as tdata
from multih_tpu_torch.utils import evaluation
from multih_tpu_torch.utils import features as tfeat
from test_torch_ops import KeyDraws

SLICE = dict(max_points=256, agree_block=128, n_hypotheses=512,
             n_candidates=64, max_labels=8, knn_window=False,
             knn_approx=False)
SEEDS = (5, 7)


class JaxReplayDraws(KeyDraws):
    """Draw source for the port's fit that replays `multih_tpu.fit`'s
    draws for `key`: `stream` is the progressive round, whose JAX key
    splits into the uniform half's key and the localized half's, or
    ("epipolar", j), half j of the split of the affine pool's F key k_f
    (pipeline.py:1174, epipolar.py:106)."""

    def __init__(self, key, rounds):
        _, k_gen, k_f = jax.random.split(key, 3)
        self.round_keys = jax.random.split(k_gen, rounds)
        self.f_keys = jax.random.split(k_f)

    def keys(self, stream):
        if isinstance(stream, tuple) and stream[0] == "epipolar":
            k = self.f_keys[stream[1]]
            return k, k
        k_u, k_l = jax.random.split(self.round_keys[stream])
        return k_u, k_l


@pytest.fixture(scope="module")
def fits():
    """(JAX result, port result, scene) per seed, one JAX compile."""
    jcfg = multih_tpu.MultiHConfig(**SLICE)
    tcfg = mt.MultiHConfig.from_dict(dataclasses.asdict(jcfg))
    jf = multih_tpu.make_fit(jcfg)
    out = {}
    for seed in SEEDS:
        cs, _ = tdata.synthetic_scene(200, 3, 0.1, 0.3, seed=seed)
        x1, x2, valid = mt.pad_points(cs.x1, cs.x2, None, 256)
        key = jax.random.key(seed)
        jr = jax.device_get(jf(x1, x2, valid, key))
        tr = mt.fit(x1, x2, valid,
                    JaxReplayDraws(key, jcfg.progressive_rounds), tcfg,
                    device="cpu")
        out[seed] = (jr, tr, cs)
    return out


def _matched_planes(jr, tr, k):
    """Port plane id -> JAX plane id by Hungarian label matching."""
    mapping = evaluation.match_labels(tr.labels.numpy(),
                                      np.asarray(jr.labels), k, k)
    return {p: q for p, q in mapping.items() if p != k and q != k}


@pytest.mark.parametrize("seed", SEEDS)
class TestSliceMatchesReference:
    def test_plane_count(self, fits, seed):
        jr, tr, _ = fits[seed]
        assert int(tr.active.sum()) == int(np.asarray(jr.active).sum()) > 0

    def test_label_agreement(self, fits, seed):
        jr, tr, cs = fits[seed]
        agree = 100.0 - evaluation.misclassification_error(
            tr.labels.numpy(), np.asarray(jr.labels), 8, gt_outlier=8)
        assert agree >= 99.0, agree
        # and both recover the scene
        gt = np.pad(cs.gt_labels, (0, 56), constant_values=-1)
        assert evaluation.misclassification_error(
            tr.labels.numpy(), gt, 8) < 5.0

    def test_homographies(self, fits, seed):
        """Matched planes within 2e-3 max-abs (Frobenius-normalized,
        h33 >= 0), not the 1e-3 first planned: labels and counts agree
        exactly, and the stage that diverges is the float32 moment refit
        (test_refit_float32_floor) — every refit of either package is
        5e-4 to 8e-4 from float64, and ~30 refits of the same members
        (LO + PEARL) drift the two fixed points up to 1.006e-3 apart
        (seed 5; 0.07 px of transfer at the scene's points)."""
        jr, tr, _ = fits[seed]
        pairs = _matched_planes(jr, tr, 8)
        assert len(pairs) == int(tr.active.sum())
        jh = np.asarray(jr.homographies)
        th = tr.homographies.numpy()
        for p, q in pairs.items():
            assert np.abs(th[p] - jh[q]).max() < 2e-3, (p, q)

    def test_energy(self, fits, seed):
        jr, tr, _ = fits[seed]
        np.testing.assert_allclose(float(tr.energy), float(jr.energy),
                                   rtol=1e-3)
        assert tr.energy_trace.shape == (8,)

    def test_counters(self, fits, seed):
        jr, tr, _ = fits[seed]
        assert float(tr.n_hypotheses_ok) == float(jr.n_hypotheses_ok)
        assert int(tr.n_far_dropped) == int(jr.n_far_dropped) == 0
        js = np.asarray(jr.support)
        for p, q in _matched_planes(jr, tr, 8).items():
            assert abs(float(tr.support[p]) - js[q]) <= 2.0


def reference_fit_x64(jf, x1, x2, valid, key):
    """The reference's fit run in float64 (jax x64) on the float32 run's
    draws: randint and gumbel at the dtypes they draw without x64, so the
    same keys give the same samples. A float64 judge of two float32
    fits that is not the port's code."""
    ri, gu = jax.random.randint, jax.random.gumbel
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax.random, "randint",
                   lambda k, shape, lo, hi, dtype=None: ri(
                       k, shape, lo, hi, dtype=jnp.int32))
        mp.setattr(jax.random, "gumbel",
                   lambda k, shape=(), dtype=None, **kw: gu(
                       k, shape, dtype=jnp.float32, **kw).astype(jnp.float64))
        return jax.device_get(jf(*(a.astype(np.float64)
                                   for a in (x1, x2, valid)), key))


@pytest.fixture(scope="module")
def stress_shaped_fits():
    """The stress config's code paths at a small size (bench.py
    _stress_cfg with the slice's changes): two progressive rounds of 4
    claims, a 4x-subsampled verify pre-pass with a transfer ranking
    residual and a full-resolution rescore, 5 PEARL iterations."""
    kw = dict(max_points=512, n_hypotheses=1024, residual_chunk=256,
              progressive_rounds=2, claims_per_round=4, verify_subsample=4,
              claim_subsample=4, pearl_iterations=5,
              rank_residual="transfer", agree_block=128,
              meanfield_iterations=4, icm_iterations=1, n_candidates=64,
              max_labels=8, knn_window=False, knn_approx=False)
    jcfg = multih_tpu.MultiHConfig(**kw)
    tcfg = mt.MultiHConfig.from_dict(dataclasses.asdict(jcfg))
    jf = multih_tpu.make_fit(jcfg)
    out = {}
    for seed in (11, 12):
        cs, _ = tdata.synthetic_scene(480, 6, 0.5, 0.5, seed=seed)
        x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 512)
        key = jax.random.key(seed)
        jr = jax.device_get(jf(x1, x2, valid, key))
        tr = mt.fit(x1, x2, valid, JaxReplayDraws(key, 2), tcfg,
                    device="cpu")
        out[seed] = (jr, tr, gt, reference_fit_x64(jf, x1, x2, valid, key))
    return out


@pytest.mark.parametrize("seed", (11, 12))
def test_stress_shaped_slice(stress_shaped_fits, seed):
    """Plane count, labels and counters as the reference's; the energy
    within rtol 1e-3 of the reference's fit run in float64
    (`reference_fit_x64`). On seed 12 the two float32 fits take one plane
    from different candidates, and the float64 reference lands on the
    port's: energies 478.63 (port, float32), 478.63 (reference, float64)
    and 480.31 (reference, float32), measured on an AVX-512 CPU."""
    jr, tr, gt, jr64 = stress_shaped_fits[seed]
    assert int(tr.active.sum()) == int(np.asarray(jr.active).sum()) == 6
    agree = 100.0 - evaluation.misclassification_error(
        tr.labels.numpy(), np.asarray(jr.labels), 8, gt_outlier=8)
    assert agree >= 99.0, agree
    assert float(tr.n_hypotheses_ok) == float(jr.n_hypotheses_ok)
    np.testing.assert_allclose(float(tr.energy), float(jr64.energy),
                               rtol=1e-3)
    assert evaluation.misclassification_error(tr.labels.numpy(), gt,
                                              8) < 3.0


def test_refit_float32_floor():
    """The stage where the two fits part: one moment refit of the GT
    members. Each float32 package is only 5e-4 to 8e-4 from the float64
    refit (normal equations square the condition number), so matched
    homographies can drift apart by that much per refit."""
    from multih_tpu.ops import geometry as jgeo

    cs, _ = tdata.synthetic_scene(200, 3, 0.1, 0.3, seed=5)
    w = np.stack([(cs.gt_labels == p).astype(np.float32)
                  for p in (1, 2, 3)])
    tb = tgeo.prepare_refit(torch.from_numpy(cs.x1), torch.from_numpy(cs.x2))
    th = tgeo.homography_refit_batch(torch.from_numpy(w), tb, "eigh").numpy()
    jb = jgeo.prepare_refit(jnp.asarray(cs.x1), jnp.asarray(cs.x2))
    jh = np.asarray(jgeo.homography_refit_batch(jnp.asarray(w), jb, "eigh"))
    b64 = tgeo.prepare_refit(torch.from_numpy(cs.x1).double(),
                             torch.from_numpy(cs.x2).double())
    h64 = tgeo.homography_refit_batch(torch.from_numpy(w).double(), b64,
                                      "eigh").numpy()
    for h in (th, jh):
        assert 1e-5 < np.abs(h - h64).max() < 1e-3
    assert np.abs(th - jh).max() < 1e-3


def test_stage_inputs_match(fits):
    """The stages before the refits agree exactly on seed 5's scene:
    the Morton order and both k-NN graphs (spatial and sampling)."""
    from multih_tpu.models import labeling as jlab
    from multih_tpu_torch.models import labeling as tlab

    _, _, cs = fits[5]
    x1, x2, valid = mt.pad_points(cs.x1, cs.x2, None, 256)
    jperm = np.asarray(jpipe.morton_order(jnp.asarray(x1), jnp.asarray(valid)))
    tperm = tpipe.morton_order(torch.from_numpy(x1), torch.from_numpy(valid))
    np.testing.assert_array_equal(tperm.numpy(), jperm)
    x1, x2, valid = x1[jperm], x2[jperm], valid[jperm]
    feat = np.concatenate([x1, 2.0 * (x2 - x1)], axis=1)
    for f in (x1, feat):
        ji, jw = jlab.knn_graph(jnp.asarray(f), jnp.asarray(valid), 6)
        ti, tw = tlab.knn_graph(torch.from_numpy(f), torch.from_numpy(valid), 6)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


# the default config's graph path at each size (knn_approx is on by
# default; the port builds the exact graph for it)
DEFAULT_GRAPH = {256: "row_blocked_approx", 200: "row_blocked_approx",
                 512: "windowed"}


@pytest.mark.parametrize("n_pts,expect", [
    (256, "row_blocked"), (200, "row_blocked"), (512, "row_blocked"),
])
def test_gates_match_reference(n_pts, expect):
    for kw in (dict(knn_window=False, knn_approx=False),
               dict(knn_window=False), dict(), dict(agree_block=0)):
        jcfg = multih_tpu.MultiHConfig(**kw)
        tcfg = mt.MultiHConfig.from_dict(dataclasses.asdict(jcfg))
        assert tpipe.graph_path(tcfg, n_pts) == jpipe.graph_path(jcfg, n_pts)
        assert tpipe.banded_gate(tcfg, n_pts) == jpipe.banded_gate(jcfg,
                                                                   n_pts)
    cfg = mt.MultiHConfig(knn_window=False, knn_approx=False)
    assert tpipe.graph_path(cfg, n_pts) == expect
    assert tpipe.graph_path(mt.MultiHConfig(), n_pts) == DEFAULT_GRAPH[n_pts]
    assert not tpipe._kernels_enabled(cfg, torch.device("cpu"))


def test_golden_outlier50_b_on_reference_draws():
    """outlier50_b's golden bound (|3-key mean - golden| <= 0.5 pp + two
    points of slack, tests/test_golden_parity.py:85-98) on the
    reference's own draws of keys 0-2, replayed into the port's fit.
    test_torch_kernels.py::test_golden_scene draws the port's keys 0-2
    from torch generators, and on an AVX-512 CPU they miss this scene's
    bound (2.22 pp against a golden 1.00); on the reference's draws the
    port's mean is 1.556 and the reference's 1.389 on the same CPU: the
    two part at the draws, not in the fit."""
    import os

    cs = tdata.suite_scene("outlier50_b")
    npad = 1 << max(9, (cs.n_points - 1).bit_length())
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                             "outlier50_b.npz"))
    tau = float(g["inlier_threshold"])
    jcfg = multih_tpu.MultiHConfig(max_points=npad)
    jf = multih_tpu.make_fit_tau(jcfg)
    tf = mt.make_fit_tau(mt.MultiHConfig(max_points=npad), device="cpu")
    x1, x2, valid = mt.pad_points(cs.x1, cs.x2, None, npad)
    errs = {"port": [], "reference": []}
    for k in range(3):
        key = jax.random.key(k)
        for name, res in (
                ("reference", jax.device_get(jf(x1, x2, valid, key, tau))),
                ("port", tf(x1, x2, valid, JaxReplayDraws(
                    key, jcfg.progressive_rounds), tau))):
            errs[name].append(evaluation.misclassification_error(
                np.asarray(res.labels)[:cs.n_points], cs.gt_labels,
                jcfg.max_labels))
    golden = float(g["misclassification"])
    bound = 0.5 + min(2.0 * 100.0 / cs.n_points, 1.0) + 1e-9
    for name, e in errs.items():
        assert abs(np.mean(e) - golden) <= bound, (name, e, golden)


@pytest.mark.parametrize("kw", [
    # the fundamental model with its direct (non-moment) refit
    dict(model="fundamental", refit_moments=False),
    dict(mrf_fused_front=True),            # at the default (windowed) graph
    dict(refit_moments=False),
    dict(knn_window=False, mrf_fused_front=True),
    dict(knn_window=False, refit_moments=False),
    dict(knn_window=False, agree_block=0),  # gather-path labeling: runs
    dict(model="fundamental", mrf_fused_front=True),
], ids=["fundamental", "fused_front_windowed", "direct_refit_windowed",
        "fused_front", "direct_refit", "gather_labeling",
        "fundamental_fused_front"])
def test_out_of_slice_raises(kw):
    """The configs that were outside the port's first slices, each now
    in it. The direct refit (refit_moments=False: the batched normalized
    DLT or 8-point F, tests/test_torch_affine.py holds it to the
    reference) and the gather-path labeling (agree_block=0: no band,
    tests/test_torch_gather.py) fit on the CPU to labels in range and
    the scene's 2 planes or motions. On the CPU (and for the fundamental
    model anywhere) fused_front_gate keeps the unfused route, so the fit
    with mrf_fused_front equals the fit without it."""
    cfg = dataclasses.replace(mt.MultiHConfig(max_points=512, **kw),
                              n_hypotheses=256)
    if cfg.model == "fundamental":
        cs, _ = tdata.synthetic_motion_scene(400, 2, 0.1, 0.5, seed=3)
    else:
        cs, _ = tdata.synthetic_scene(400, 2, 0.1, 0.5, seed=3)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 512)
    if not cfg.mrf_fused_front:
        res = mt.fit(x1, x2, valid, torch.Generator().manual_seed(0), cfg,
                     device="cpu")
        lab = res.labels.numpy()
        assert lab.dtype == np.int32 and lab.shape == (512,)
        assert lab.min() >= 0 and lab.max() <= cfg.max_labels
        assert (lab[400:] == cfg.max_labels).all()
        assert bool(torch.isfinite(res.homographies).all())
        assert int(res.active.sum()) == 2
        assert evaluation.misclassification_error(lab, gt,
                                                  cfg.max_labels) < 3.0
        return
    fused, plain = (
        mt.fit(x1, x2, valid, torch.Generator().manual_seed(0), c,
               device="cpu")
        for c in (cfg, dataclasses.replace(cfg, mrf_fused_front=False)))
    assert torch.equal(fused.labels, plain.labels)
    assert torch.equal(fused.homographies, plain.homographies)
    assert torch.equal(fused.energy_trace, plain.energy_trace)


@pytest.mark.parametrize("model", ["homography", "fundamental"])
def test_out_of_slice_arguments_raise(model):
    """A 'pt' (point) mesh runs both models on both graphs: on a one-rank
    'pt' mesh the exact graph (knn_window=False) with this model equals
    `fit` without a mesh, every output bit for bit
    (tests/test_torch_mesh.py holds 2 and 4 ranks), and a block that does
    not divide N or is odd raises the gate's ValueError
    (pipeline.check_pt_gate).
    Affine hypotheses run for homographies (tests/test_torch_affine.py
    holds them to the reference) and raise the reference's ValueError for
    the fundamental model; seed homographies are in the port
    (tests/test_torch_stream.py)."""
    cfg = mt.MultiHConfig(max_points=512, knn_window=False, model=model)
    z = torch.zeros((512, 2))
    pt_mesh = Mesh([0], ("pt",), device="cpu")
    if model == "fundamental":
        cs, _ = tdata.synthetic_motion_scene(300, 2, 0.1, 0.5, seed=3)
        cfg_pt = dataclasses.replace(cfg, residual="sampson",
                                     n_hypotheses=256, max_labels=8)
    else:
        cs, _ = tdata.synthetic_scene(300, 2, 0.1, 0.5, seed=21)
        cfg_pt = dataclasses.replace(cfg, n_hypotheses=256)
    args = mt.pad_points(cs.x1, cs.x2, None, 512)
    got, ref = (mt.fit(*args, torch.Generator().manual_seed(0), cfg_pt,
                       mesh=m, device="cpu") for m in (pt_mesh, None))
    assert int(ref.active.sum()) == 2
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="multiple of"):
        mt.fit(z, z, torch.ones(512), torch.Generator(), dataclasses.replace(
            cfg, agree_block=384), mesh=pt_mesh)
    with pytest.raises(ValueError, match="even agree_block"):
        mt.fit(z, z, torch.ones(512), torch.Generator(), dataclasses.replace(
            cfg, agree_block=1), mesh=pt_mesh)
    if model == "fundamental":
        with pytest.raises(ValueError, match="affine"):
            mt.fit(z, z, torch.ones(512), torch.Generator(), cfg,
                   affines=torch.zeros((512, 2, 2)))
        return
    cs, Hs = tdata.synthetic_scene(300, 2, 0.1, 0.3, seed=21)
    aff = tfeat.affines_from_homographies(Hs, cs.gt_labels - 1, cs.x1, -1)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 512)
    A = np.tile(np.eye(2, dtype=np.float32), (512, 1, 1))
    A[:300] = aff
    res = mt.fit(x1, x2, valid, torch.Generator().manual_seed(0),
                 dataclasses.replace(cfg, n_hypotheses=256), affines=A,
                 device="cpu")
    assert int(res.active.sum()) == 2
    # the pool holds one extra hypothesis a valid point
    assert float(res.n_hypotheses_ok) > 300
    assert evaluation.misclassification_error(res.labels.numpy(), gt,
                                              cfg.max_labels) < 3.0


def test_fundamental_model_runs():
    """model="fundamental" is in the slice: an all-outlier scene fits on
    the CPU to no motion (test_fmodel_pipeline.py's outlier case)."""
    rng = np.random.default_rng(5)
    x1, x2, valid = mt.pad_points(
        rng.uniform(0, 640, (300, 2)), rng.uniform(0, 640, (300, 2)), None,
        512)
    cfg = mt.MultiHConfig(max_points=512, model="fundamental",
                          residual="sampson")
    res = mt.fit(x1, x2, valid, torch.Generator().manual_seed(0), cfg,
                 device="cpu")
    assert int(res.active.sum()) == 0
    assert res.energy_trace.shape == (12,)
