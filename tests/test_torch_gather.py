"""The port's gather-path labeling (no banded adjacency) against the JAX
package, and the port's fit on that path.

The labeling functions take the same seeded numpy inputs as their jnp
versions, called eagerly: unsorted points, N=200, k=6, L=9, the JAX
package's exact k-NN graph on both sides. The fit runs where the banded
gate is off (N=320 is no multiple of agree_block 128, and spatial_sort
off), against `multih_tpu.make_fit` on replayed draws: one JAX compile.
The mixed fit's stages take this path too (tests/test_torch_mixed.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multih_tpu
from multih_tpu.models import labeling as jlab

import multih_tpu_torch as mt
from multih_tpu_torch.models import labeling as tlab
from multih_tpu_torch.models import pipeline as tpipe
from multih_tpu_torch.utils import data as tdata
from multih_tpu_torch.utils import evaluation
from test_torch_kernels import t
from test_torch_windowed import FitReplayDraws

torch.set_num_threads(1)

N, K, L = 200, 6, 9


@pytest.fixture(scope="module")
def graph():
    """Unsorted points with 20 padded ones, the JAX k-NN graph, and data
    costs (L, N), zero on the padding, that favour one label of 3x3
    spatial cells each (noisy, so the smoothing has work to do)."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 100, (N, 2)).astype(np.float32)
    valid = np.ones(N, np.float32)
    valid[rng.choice(N, 20, replace=False)] = 0.0
    ji, jw = jlab.knn_graph(jnp.asarray(pts), jnp.asarray(valid), K)
    cell = (np.minimum(pts[:, 0] // 34, 2) * 3
            + np.minimum(pts[:, 1] // 34, 2)).astype(np.int64)
    dct = rng.uniform(0.5, 2.0, (L, N))
    dct[cell, np.arange(N)] = rng.uniform(0.0, 0.9, N)
    dct = (dct * valid[None, :]).astype(np.float32)
    return dict(pts=pts, idx=np.asarray(ji), w=np.asarray(jw), dct=dct,
                valid=valid)


def j(g, *names):
    return [jnp.asarray(g[n]) for n in names]


def tt(g, *names):
    return [t(g[n]) for n in names]


def test_knn_graph_equal_on_unsorted_points(graph):
    """The gather path's graph: the port's exact k-NN equals JAX's on
    points in no particular order."""
    ti, tw = tlab.knn_graph(t(graph["pts"]), t(graph["valid"]), K)
    np.testing.assert_array_equal(ti.numpy(), graph["idx"])
    np.testing.assert_array_equal(tw.numpy(), graph["w"])


def test_neighbor_agreement_and_degree(graph):
    q = np.asarray(jax.nn.softmax(-jnp.asarray(graph["dct"]) / 0.5, axis=0))
    ji, jw = j(graph, "idx", "w")
    ti, tw = tt(graph, "idx", "w")
    ref = np.asarray(jlab._neighbor_agreement(jnp.asarray(q.T), ji, jw)).T
    got = tlab._neighbor_agreement_t(t(q), ti, tw).numpy()
    assert np.abs(got - ref).max() <= 1e-6
    deg_ref = np.asarray(jlab._degree(ji, jw, jnp.float32))
    deg = tlab._degree(ti, tw, torch.float32).numpy()
    assert deg.shape == deg_ref.shape == (N, 1)
    assert np.abs(deg - deg_ref).max() <= 1e-6
    # the agreement of all-ones marginals is the degree
    ones = tlab._neighbor_agreement_t(torch.ones((1, N)), ti, tw)
    np.testing.assert_allclose(ones.numpy()[0], deg[:, 0], atol=1e-6)


@pytest.mark.parametrize("q_init", [False, True])
def test_mean_field_gather(graph, q_init):
    ji, jw, jd = j(graph, "idx", "w", "dct")
    ti, tw, td = tt(graph, "idx", "w", "dct")
    q0 = None
    if q_init:
        q0 = np.asarray(jax.nn.softmax(-jd / 3.0, axis=0))
    ref = np.asarray(jlab.mean_field_t(
        jd, ji, jw, 0.6, 6, 2.0, 0.25,
        q_init=None if q0 is None else jnp.asarray(q0)))
    got = tlab.mean_field_t(td, ti, tw, 0.6, 6, 2.0, 0.25,
                            q_init=None if q0 is None else t(q0))
    assert got.shape == (L, N)
    assert np.abs(got.numpy() - ref).max() <= 1e-5


def _random_labels(seed):
    return np.random.default_rng(seed).integers(0, L, N).astype(np.int32)


ICM_CASES = dict(sweeps=(0.6, 3, "argmin"), constant_escape=(0.6, 1, 3))


def _icm_start(graph, which):
    if which == "argmin":
        return graph["dct"].argmin(0).astype(np.int32)
    return _random_labels(which)


@pytest.mark.parametrize("case", ["sweeps", "constant_escape", "batched"])
def test_icm_labels_exact(graph, case):
    """ICM labels equal JAX's `icm` exactly: from the data argmin at
    spatial weight 0.6 the sweeps move points and keep the cells; from a
    random start, single-point moves cannot dissolve the islands, and the
    constant-labeling escape fires (every point takes one label). The
    port polishes its starts together (`_icm_batch` without a band);
    "batched" runs both starts in one call at the escape case's
    settings, where the escape fires for one of them only."""
    ji, jw, jd = j(graph, "idx", "w", "dct")
    ti, tw, td = tt(graph, "idx", "w", "dct")
    if case == "batched":
        sw, its, _ = ICM_CASES["constant_escape"]
        whichs = ("argmin", 3)
    else:
        sw, its, which = ICM_CASES[case]
        whichs = (which,)
    starts = np.stack([_icm_start(graph, w) for w in whichs])
    got = tlab._icm_batch(t(starts), td, sw, its, None, nbr_idx=ti,
                          nbr_w=tw)
    assert got.dtype == torch.int32 and got.shape == starts.shape
    refs = [np.asarray(jlab.icm(jnp.asarray(s), jd.T, ji, jw, sw, its))
            for s in starts]
    for g, ref, s in zip(got.numpy(), refs, starts):
        np.testing.assert_array_equal(g, ref)
    constant = [len(np.unique(r)) == 1 for r in refs]
    if case == "batched":
        assert constant == [False, True]
    else:
        assert constant == [case == "constant_escape"]
    if case == "sweeps":
        assert (refs[0] != starts[0]).any()


def test_energies(graph):
    """The data + Potts energies of a batch of labelings against JAX's
    `mrf_energy_t`, the Potts term alone exactly (0/1 weights: its sums
    are exact), and `total_energy_t`."""
    ji, jw, jd = j(graph, "idx", "w", "dct")
    ti, tw, td = tt(graph, "idx", "w", "dct")
    labs = np.stack([_random_labels(5), _random_labels(6)])
    active = np.array([1, 1, 0, 1, 1, 0, 1, 1], np.float32)
    agree_fn, deg = tlab._agree_and_deg_t(ti, tw, None, torch.float32)
    e = tlab._energies_batch(t(labs), td, agree_fn, deg, 0.6).numpy()
    potts = tlab._energies_batch(t(labs), torch.zeros_like(td), agree_fn,
                                 deg, 1.0).numpy()
    for i, lab in enumerate(labs):
        e_ref = float(jlab.mrf_energy_t(jnp.asarray(lab), jd, ji, jw, 0.6))
        np.testing.assert_allclose(e[i], e_ref, rtol=1e-5)
        assert potts[i] == float(jlab.potts_energy(jnp.asarray(lab), ji, jw))
    lab = labs[0]
    tot_ref = float(jlab.total_energy_t(jnp.asarray(lab), jd, ji, jw, 0.6,
                                        7.0, jnp.asarray(active)))
    tot = float(tlab.total_energy_t(t(lab), td, ti, tw, 0.6, 7.0,
                                    t(active)))
    np.testing.assert_allclose(tot, tot_ref, rtol=1e-5)


def test_best_labeling_gather_exact(graph):
    """Two starts (the mean-field argmax and the data argmin), polished
    together; the lower MRF energy wins, as one JAX `icm` a start and
    `mrf_energy` pick it."""
    ji, jw, jd = j(graph, "idx", "w", "dct")
    ti, tw, td = tt(graph, "idx", "w", "dct")
    q = jlab.mean_field_t(jd, ji, jw, 0.6, 4, 2.0, 0.5)
    starts = [jnp.argmax(q, axis=0), jnp.argmin(jd, axis=0)]
    ref = np.asarray(jlab.best_labeling_t(starts, jd, ji, jw, 0.6, 2))
    got = tlab.best_labeling_t([t(np.asarray(s)) for s in starts], td, ti,
                               tw, 0.6, 2)
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# the fit on the gather path
# ---------------------------------------------------------------------------

# n_candidates 64 as test_torch_pipeline's slice config (see
# test_torch_mixed.PARITY for why)
GATHER_CFG = dict(max_points=320, agree_block=128, n_hypotheses=512,
                  n_candidates=64, max_labels=8, spatial_sort=False)


@pytest.fixture(scope="module")
def gather_fit():
    """(JAX result, port result, gt) on one scene, one JAX compile."""
    jcfg = multih_tpu.MultiHConfig(**GATHER_CFG)
    tcfg = mt.MultiHConfig.from_dict(dataclasses.asdict(jcfg))
    assert not tpipe.banded_gate(tcfg, 320)
    cs, _ = tdata.synthetic_scene(300, 3, 0.1, 0.5, seed=8)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 320)
    key = jax.random.key(3)
    jr = jax.device_get(multih_tpu.make_fit(jcfg)(x1, x2, valid, key))
    tr = mt.fit(x1, x2, valid, FitReplayDraws(key, jcfg.progressive_rounds),
                tcfg, device="cpu")
    return jr, tr, gt


def test_gather_fit_matches_reference(gather_fit):
    """Unsorted points, N no multiple of agree_block: labels and active
    exact, matched H's within 2e-3 (the refit floor, ROADMAP §3), the
    energy within 1e-3, no far edges counted."""
    jr, tr, gt = gather_fit
    np.testing.assert_array_equal(tr.labels.numpy(), np.asarray(jr.labels))
    np.testing.assert_array_equal(tr.active.numpy(), np.asarray(jr.active))
    assert int(tr.active.sum()) == 3
    jh, th = np.asarray(jr.homographies), tr.homographies.numpy()
    for p in np.flatnonzero(tr.active.numpy()):
        assert np.abs(th[p] - jh[p]).max() < 2e-3, p
    np.testing.assert_allclose(float(tr.energy), float(jr.energy), rtol=1e-3)
    assert tr.n_far_dropped.dtype == torch.int32
    assert int(tr.n_far_dropped) == int(jr.n_far_dropped) == 0
    assert evaluation.misclassification_error(tr.labels.numpy(), gt, 8) < 3.0


# the fundamental model on the same path: two motions, no plane, so no F
# is fitted to a plane's points (where every F = [e']x H fits alike and
# the packages' float32 refits part; tests/test_torch_mixed.py). The
# motion moves that split, exclusive-refine and resample are held in
# tests/test_torch_fmodel.py, and the claim rounds in the H fit above:
# without them the JAX compile takes ~20 s on a CPU, not ~70 s
F_GATHER_CFG = dict(GATHER_CFG, max_labels=4, model="fundamental",
                    residual="sampson", progressive_rounds=1,
                    f_split_refine=False, f_exclusive_refine=False,
                    f_resample_lo=False)


@pytest.fixture(scope="module")
def gather_fit_f():
    """(JAX result, port result, gt) of one F fit, one JAX compile."""
    from test_torch_fmodel import FitReplayDrawsF

    jcfg = multih_tpu.MultiHConfig(**F_GATHER_CFG)
    tcfg = mt.MultiHConfig.from_dict(dataclasses.asdict(jcfg))
    assert not tpipe.banded_gate(tcfg, 320)
    cs, _, _ = tdata.synthetic_mixed_scene(300, 0, 2, 0.1, 0.5, seed=2)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 320)
    key = jax.random.key(0)
    jr = jax.device_get(multih_tpu.make_fit(jcfg)(x1, x2, valid, key))
    tr = mt.fit(x1, x2, valid,
                FitReplayDrawsF(key, jcfg.progressive_rounds), tcfg,
                device="cpu")
    return jr, tr, gt


def test_gather_fit_f_matches_reference(gather_fit_f):
    """The F fit on the gather path (unsorted points, N no multiple of
    agree_block): labels and active exact, matched F's within 2e-3, the
    energy within 1e-3, both motions recovered."""
    jr, tr, gt = gather_fit_f
    np.testing.assert_array_equal(tr.labels.numpy(), np.asarray(jr.labels))
    np.testing.assert_array_equal(tr.active.numpy(), np.asarray(jr.active))
    assert int(tr.active.sum()) == 2
    jf, tf = np.asarray(jr.homographies), tr.homographies.numpy()
    for p in np.flatnonzero(tr.active.numpy()):
        assert np.abs(tf[p] - jf[p]).max() < 2e-3, p
    np.testing.assert_allclose(float(tr.energy), float(jr.energy), rtol=1e-3)
    assert int(tr.n_far_dropped) == 0
    assert evaluation.misclassification_error(tr.labels.numpy(), gt, 4) < 3.0
