"""The port's batch surface (parallel/sharding.py) against the JAX
package's `run_benchmark_batch`, and against the port's own single fits.

One JAX compile: `sharding.run_benchmark_batch` on 2 pairs at
tests/test_sharding.py's tiny_cfg with a one-device mesh and per-pair
taus. The port's batch takes draw sources that replay the JAX keys
jax.random.key(i). The rest runs the port alone: each pair of a batch is
the single fit of that pair, bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import multih_tpu
from multih_tpu.parallel import sharding as jshard

import multih_tpu_torch as mt
from multih_tpu_torch.parallel import sharding as tshard
from multih_tpu_torch.parallel.mesh import Mesh
from multih_tpu_torch.utils import data as tdata
from multih_tpu_torch.utils import evaluation
from test_torch_pipeline import JaxReplayDraws

torch.set_num_threads(1)

TINY = dict(max_points=128, n_hypotheses=512, n_candidates=64, max_labels=8)
TAUS = [3.0, 4.5]


@pytest.fixture(scope="module")
def pairs():
    return [tdata.synthetic_scene(96, 2, 0.1, 0.5, seed=s)[0]
            for s in range(2)]


@pytest.fixture(scope="module")
def tcfg():
    return mt.MultiHConfig(**TINY)


@pytest.fixture(scope="module")
def batches(pairs, tcfg):
    """(JAX batch, port batch on replayed draws), both as numpy."""
    jcfg = multih_tpu.MultiHConfig(**TINY)
    mesh = jshard.make_mesh(jax.devices()[:1])
    jr = jshard.run_benchmark_batch(pairs, jcfg, mesh=mesh, taus=TAUS)
    (x1, x2, valid, taus), b = tshard.prepare_benchmark_batch(
        pairs, tcfg, taus=TAUS, device="cpu")
    keys = [JaxReplayDraws(jax.random.key(i), tcfg.progressive_rounds)
            for i in range(b)]
    tr = tshard.batched_fit(tcfg)(x1, x2, valid, keys, taus)
    return jr, type(tr)(*(a.numpy() for a in tr))


@pytest.mark.parametrize("i", [0, 1])
def test_batch_matches_reference(batches, i):
    """Per pair: planes exact, labels >= 99% equal, matched H's within
    2e-3, energy to 1e-3, hypothesis count exact."""
    jr, tr = batches
    assert tr.labels.shape == jr.labels.shape == (2, 128)
    assert int(tr.active[i].sum()) == int(jr.active[i].sum()) == 2
    agree = 100.0 - evaluation.misclassification_error(
        tr.labels[i], jr.labels[i], 8, gt_outlier=8)
    assert agree >= 99.0, agree
    mapping = evaluation.match_labels(tr.labels[i], jr.labels[i], 8, 8)
    for p, q in mapping.items():
        if p != 8 and q != 8:
            assert np.abs(tr.homographies[i][p]
                          - jr.homographies[i][q]).max() < 2e-3
    np.testing.assert_allclose(tr.energy[i], jr.energy[i], rtol=1e-3)
    assert tr.n_hypotheses_ok[i] == jr.n_hypotheses_ok[i]


@pytest.mark.parametrize("adaptive", [False, True])
def test_batch_pairs_are_single_fits(pairs, tcfg, adaptive):
    """Pair i of run_benchmark_batch is the port's single fit of pair i
    with torch.Generator().manual_seed(seed + i) at tau i, bit for bit
    (with `adaptive`, fit_adaptive's, taus ignored)."""
    res = tshard.run_benchmark_batch(pairs, tcfg, seed=5, taus=TAUS,
                                     adaptive=adaptive, device="cpu")
    for i, cs in enumerate(pairs):
        pts = mt.pad_points(cs.x1, cs.x2, None, tcfg.max_points)
        gen = torch.Generator().manual_seed(5 + i)
        if adaptive:
            single, _ = mt.fit_adaptive(*pts, gen, tcfg, device="cpu")
        else:
            single = mt.fit(*pts, gen, tcfg, tau=TAUS[i], device="cpu")
        for name, a in single._asdict().items():
            b = getattr(res, name)[i]
            assert a.numpy().dtype == b.dtype, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        assert int(single.active.sum()) == 2


def test_padding_and_cut(tcfg):
    """Pairs of different sizes padded to one max_points: the stacked
    batch has B rows, padded points are invalid and labeled outlier, and
    a prepared batch is reused across calls."""
    pairs = [tdata.synthetic_scene(n, 2, 0.1, 0.5, seed=s)[0]
             for s, n in ((3, 60), (4, 110), (5, 90))]
    prepared = tshard.prepare_benchmark_batch(pairs, tcfg, device="cpu")
    (x1, x2, valid, taus), b = prepared
    assert b == 3 and x1.shape == (3, 128, 2) and valid.shape == (3, 128)
    assert taus.tolist() == [tcfg.inlier_threshold] * 3
    assert valid.sum(1).tolist() == [60.0, 110.0, 90.0]
    res = tshard.run_benchmark_batch(pairs, tcfg, prepared=prepared)
    again = tshard.run_benchmark_batch(pairs, tcfg, prepared=prepared)
    assert res.labels.shape == (3, 128) and res.homographies.shape == (
        3, 8, 3, 3)
    for i, cs in enumerate(pairs):
        assert (res.labels[i][cs.n_points:] == tcfg.max_labels).all()
        err = evaluation.misclassification_error(
            res.labels[i][:cs.n_points], cs.gt_labels, tcfg.max_labels)
        assert err < 10.0, (i, err)
    np.testing.assert_array_equal(res.labels, again.labels)


@pytest.fixture(scope="module")
def mixed_cfgs():
    cfg_h = mt.MultiHConfig(max_points=320, agree_block=128,
                            n_hypotheses=512, max_labels=4)
    return cfg_h, dataclasses.replace(cfg_h, model="fundamental",
                                      residual="sampson")


def test_batched_fit_mixed_equals_fit_mixed(mixed_cfgs):
    """batched_fit_mixed's pair i is mt.fit_mixed of pair i with the same
    generator seed, every leaf of the nested result bit for bit."""
    cfg_h, cfg_f = mixed_cfgs
    scenes = [tdata.synthetic_mixed_scene(300, 1, 1, 0.1, 0.5, seed=s)[0]
              for s in (9, 10)]
    padded = [mt.pad_points(cs.x1, cs.x2, None, 320) for cs in scenes]
    x1, x2, valid = (np.stack([p[j] for p in padded]) for j in range(3))
    res = tshard.batched_fit_mixed(cfg_h, cfg_f, device="cpu")(
        x1, x2, valid, [torch.Generator().manual_seed(i) for i in (0, 1)])
    assert res.labels.shape == (2, 320)
    assert res.result_h.homographies.shape == (2, 4, 3, 3)
    for i in range(2):
        single = mt.fit_mixed(*padded[i], torch.Generator().manual_seed(i),
                              cfg_h, cfg_f, device="cpu")
        for name in ("labels", "models", "is_f", "active", "support",
                     "energy"):
            assert torch.equal(getattr(res, name)[i], getattr(single, name))
        assert torch.equal(res.result_f.labels[i], single.result_f.labels)
        assert int(single.active.sum()) >= 2


def test_mixed_adaptive_with_taus_raises(mixed_cfgs):
    with pytest.raises(ValueError, match="tau_h"):
        tshard.batched_fit_mixed(*mixed_cfgs, adaptive=True, tau_h=4.0)
    with pytest.raises(ValueError, match="adaptive"):
        tshard.batched_fit_mixed(*mixed_cfgs, adaptive=True, tau_f=4.0)
    # each alone is fine
    tshard.batched_fit_mixed(*mixed_cfgs, adaptive=True)
    tshard.batched_fit_mixed(*mixed_cfgs, tau_h=4.0)


@pytest.mark.parametrize("fn", ["batched_fit", "batched_fit_mixed",
                                "prepare_benchmark_batch",
                                "run_benchmark_batch"])
def test_mesh_raises(tcfg, mixed_cfgs, pairs, fn):
    """With a mesh of one rank (no process group) each surface equals the
    call without a mesh, bit for bit, its arrays on the mesh's device;
    the multi-rank meshes are tests/test_torch_mesh.py's. A 'pt' (point)
    mesh reaches the fit, whose gate (pipeline.check_pt_gate) admits
    either model on either graph but refuses the tiny config's 128
    points under agree_block 256 (N not a multiple of the block) with a
    ValueError."""
    m1 = tshard.make_mesh(device="cpu")
    x1, x2, valid = (np.stack(a) for a in zip(*(
        mt.pad_points(cs.x1, cs.x2, None, tcfg.max_points) for cs in pairs)))

    def gens():
        return [torch.Generator().manual_seed(i) for i in range(len(pairs))]

    call = {
        "batched_fit": lambda **kw: tshard.batched_fit(tcfg, **kw)(
            x1, x2, valid, gens(), TAUS),
        "batched_fit_mixed": lambda **kw: tshard.batched_fit_mixed(
            *mixed_cfgs, **kw)(*mixed_inputs(mixed_cfgs), gens()),
        "prepare_benchmark_batch": lambda **kw: tshard.prepare_benchmark_batch(
            pairs, tcfg, taus=TAUS, **kw)[0],
        "run_benchmark_batch": lambda **kw: tshard.run_benchmark_batch(
            pairs, tcfg, taus=TAUS, **kw),
    }[fn]
    a, b = call(mesh=m1), call(device="cpu")
    for x, y in zip(flat(a), flat(b)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    if fn == "batched_fit":
        pt_mesh = Mesh([0], ("pt",), device="cpu")
        with pytest.raises(ValueError, match="multiple of agree_block"):
            tshard.batched_fit(tcfg, mesh=pt_mesh)(x1, x2, valid, gens(),
                                                   TAUS)


def mixed_inputs(mixed_cfgs):
    cs = tdata.synthetic_mixed_scene(300, 1, 1, 0.1, 0.5, seed=9)[0]
    pts = mt.pad_points(cs.x1, cs.x2, None, mixed_cfgs[0].max_points)
    return tuple(np.stack([a, a]) for a in pts)


def flat(res):
    """The leaves of a (nested) tuple of arrays or tensors."""
    if isinstance(res, tuple):
        return [leaf for x in res for leaf in flat(x)]
    return [res]
