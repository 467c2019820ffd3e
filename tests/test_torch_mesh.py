"""The port's mesh axes on the CPU: parallel/mesh.py's Mesh and
collectives, parallel/sharding.py's hyp-sharded fit, sharded
verification, pair-split batches and the 'pt'-sharded fit with its
windowed sweeps, against the port's own single-device results, and two
pieces against the JAX package.

One module fixture spawns 4 gloo ranks on the CPU once
(tests/torch_mesh_ranks.py::mesh_rank, under a deadline after which the
ranks are killed and the fixture fails). Each rank writes its results as
numpy under tmp_path; each check below is a test of its own. The (1, 4),
(1, 2), (2, 2) and (4, 1) meshes are built over the 4 ranks; the (2, 2)
mesh's two rows fit different cases at once; the 'pt' meshes over all
four ranks and over ranks (0, 1) and (2, 3) at once.

In this process: `windowed_quadruples(window_range=)` against JAX's on
replayed draws, and `sharded_verification` against
``jax.lax.top_k(pipeline.count_inliers(...))`` on one CPU device. No JAX
fit is compiled.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multih_tpu
from multih_tpu.models import pipeline as jpipe
from multih_tpu.ops import sampling as jsamp

import multih_tpu_torch as mt
from multih_tpu_torch.models import pipeline as tpipe
from multih_tpu_torch.ops import sampling as tsamp
from multih_tpu_torch.ops.topk import top_k_stable
from multih_tpu_torch.parallel import mesh as tmesh
from multih_tpu_torch.parallel import sharding as tshard
from multih_tpu_torch.utils import evaluation
import torch_mesh_ranks as R
from test_torch_kernels import t
from test_torch_windowed import (KeyWindowDraws, _knn_windowed,
                                 morton_scene)

torch.set_num_threads(1)

WORLD = 4
# The reference's mean misclassification (pp) over keys 0-31 on the
# "fmodel" 'pt' case's scene and config (`python3
# tools/torch_golden_keys.py --scenes pt_fmodel`: the reference 2.0213,
# s.e. 0.0382; the port 2.0213, s.e. 0.0394). The scene's own error sits
# at 2%, so that case is held to the motion suite's contract, |delta| <=
# 2.0 pp a scene, against this mean.
REF_MEAN_FMODEL = 2.0213
SPAWN_DEADLINE_S = 90.0


@pytest.fixture(scope="module")
def ranks_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ranks")
    done = tmesh.spawn(R.mesh_rank, WORLD, "gloo", lambda r: "cpu",
                       SPAWN_DEADLINE_S, args=(str(out),))
    assert done == list(range(WORLD))
    return out


def load(out, name, rank):
    with np.load(os.path.join(out, f"{name}_r{rank}.npz")) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# the meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,devices,shape", [
    ("1x4", range(4), (1, 4)), ("1x2", range(2), (1, 2)),
    ("2x2", range(4), (2, 2)), ("4x1", range(4), (4, 1))])
def test_mesh_layout(ranks_dir, name, devices, shape):
    """Row-major ranks (sharding.py:42), coordinates, and all_gather /
    psum along each axis in axis order; a rank left out of the mesh has
    no coordinates."""
    grid = np.array(list(devices)).reshape(shape)
    for rank in range(WORLD):
        got = load(ranks_dir, f"mesh_{name}", rank)
        assert tuple(got["shape"]) == shape
        if rank not in grid:
            assert tuple(got["coords"]) == (-1, -1)
            assert "gather_hyp" not in got
            continue
        p, h = (int(c) for c in np.argwhere(grid == rank)[0])
        assert tuple(got["coords"]) == (p, h)
        np.testing.assert_array_equal(got["gather_hyp"], grid[p])
        np.testing.assert_array_equal(got["gather_pair"], grid[:, h])
        np.testing.assert_array_equal(got["psum_hyp"], [grid[p].sum()])
        np.testing.assert_array_equal(got["psum_pair"], [grid[:, h].sum()])


def test_world_one_mesh_needs_no_process_group():
    m = tshard.make_mesh(device="cpu")
    assert m.shape == {"pair": 1, "hyp": 1} and m.coords == (0, 0)
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(m.all_gather(x, "hyp"), x[None])
    assert torch.equal(m.psum(x, "pair"), x)
    assert float(m.replicated_ok([x], "hyp")) == 1.0


def test_spawn_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        tmesh.spawn(R.failing_rank, 2, "gloo", lambda r: "cpu", 60.0)


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tshard.make_mesh()


# ---------------------------------------------------------------------------
# the hyp-sharded fit against the unsharded fit
# ---------------------------------------------------------------------------

HYP_RUNS = [("hyp4", case, range(4)) for case in R.HYP4_CASES] + [
    ("hyp2", cases[row], range(2 * row, 2 * row + 2))
    for cases in R.HYP2_ROWS for row in (0, 1)]


@pytest.mark.parametrize("mesh_name,case,ranks", HYP_RUNS,
                         ids=[f"{m}-{c}" for m, c, _ in HYP_RUNS])
def test_hyp_sharded_fit_equals_fit(ranks_dir, mesh_name, case, ranks):
    """hyp_sharded_fit (fit(mesh=) with seed homographies or affine
    frames) on every rank of the 'hyp' group against the port's unsharded
    fit with the same generator seed: labels, active and n_hypotheses_ok
    exact, homographies within rtol 2e-4 / atol 2e-5
    (tests/test_sharding.py:191), and the fit solves its 2-model scene."""
    (x1, x2, valid), key, kw = R.fit_inputs(case)
    ref = mt.fit(x1, x2, valid, torch.Generator().manual_seed(key),
                 R.fit_config(case), device="cpu", **kw)
    assert int(ref.active.sum()) == 2
    for rank in ranks:
        got = load(ranks_dir, f"{mesh_name}_{case}", rank)
        for name in ("labels", "active", "n_hypotheses_ok"):
            np.testing.assert_array_equal(got[name],
                                          getattr(ref, name).numpy(),
                                          err_msg=f"rank {rank} {name}")
        np.testing.assert_allclose(got["homographies"],
                                   ref.homographies.numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_hyp_rescore_cap_counts_the_extras(ranks_dir):
    """With the one-point pool's 128 extras and verify_rescore * M = 256
    past the 131-hypothesis sampled pool, the hyp-sharded pre-selection
    is capped by the whole pool, as the unsharded pick is: every rank's
    homographies equal the single fit's bit for bit. (Capped by the
    sampled pool alone, as the reference caps it, they parted on this
    scene by 1.78 in an inactive slot.)"""
    (x1, x2, valid), key, kw = R.fit_inputs("rescore_cap")
    ref = mt.fit(x1, x2, valid, torch.Generator().manual_seed(key),
                 R.fit_config("rescore_cap"), device="cpu", **kw)
    for rank in range(WORLD):
        got = load(ranks_dir, "hyp4_rescore_cap", rank)
        np.testing.assert_array_equal(got["homographies"],
                                      ref.homographies.numpy())


def test_hypothesize_verify_replication_guard(ranks_dir):
    """The fit's sharded hypothesize + verify with its runtime
    replication guard (pipeline.py:562) on the (1, 4) mesh: every rank's
    outputs bit-equal, the guard 1."""
    outs = [load(ranks_dir, "guard_1x4", r) for r in range(WORLD)]
    for got in outs:
        assert float(got["ok"]) == 1.0
        assert got["counts"].shape == (R.TINY["n_candidates"],)
        for k in ("counts", "hs", "n_ok"):
            np.testing.assert_array_equal(got[k], outs[0][k])


# ---------------------------------------------------------------------------
# sharded verification
# ---------------------------------------------------------------------------

def _pool():
    Hs, x1, x2, valid = R.verification_pool()
    return Hs, x1, x2, valid, tpipe.count_inliers(
        t(Hs), t(x1), t(x2), t(valid), mt.MultiHConfig(**R.TINY))


@pytest.mark.parametrize("name,members", [("1x4", range(4)),
                                          ("1x2", range(2))])
def test_sharded_verification(ranks_dir, name, members):
    """Every member returns the stable top-M of the unsharded counts
    (ties: the lower index first), and its replication guard is 1; the
    ranks outside the (1, 2) mesh refuse it."""
    *_, counts = _pool()
    ref_c, ref_i = top_k_stable(counts, R.TINY["n_candidates"])
    assert len(np.unique(ref_c.numpy())) < R.TINY["n_candidates"]  # ties
    for rank in range(WORLD):
        got = load(ranks_dir, f"verify_{name}", rank)
        if rank not in members:
            assert bool(got["refused"])
            continue
        np.testing.assert_array_equal(got["counts"], ref_c.numpy())
        np.testing.assert_array_equal(got["idx"], ref_i.numpy())
        assert float(got["ok"]) == 1.0


def test_sharded_verification_matches_jax(ranks_dir):
    """The (1, 4) mesh's result against the JAX package's
    jax.lax.top_k(pipeline.count_inliers(...)) on one CPU device."""
    Hs, x1, x2, valid, _ = _pool()
    jcfg = multih_tpu.MultiHConfig(**R.TINY)
    c, i = jax.lax.top_k(jpipe.count_inliers(
        jnp.asarray(Hs), jnp.asarray(x1), jnp.asarray(x2),
        jnp.asarray(valid), jcfg), jcfg.n_candidates)
    got = load(ranks_dir, "verify_1x4", 0)
    np.testing.assert_array_equal(got["counts"], np.asarray(c))
    np.testing.assert_array_equal(got["idx"], np.asarray(i))


# ---------------------------------------------------------------------------
# the pair axis: batches split over rank rows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def no_mesh_batch():
    res = tshard.run_benchmark_batch(R.batch_pairs(),
                                     mt.MultiHConfig(**R.TINY), seed=3,
                                     taus=R.BATCH_TAUS, device="cpu")
    assert res.labels.shape == (5, R.TINY["max_points"])
    return res


@pytest.mark.parametrize("name", ["4x1", "2x2", "adaptive_2x2"])
def test_batch_on_mesh_equals_no_mesh(ranks_dir, no_mesh_batch, name):
    """run_benchmark_batch of 5 pairs (padded to 8 or 6) on the mesh:
    every rank returns every pair, bit-equal to the batch without a
    mesh (on (2, 2) each pair's pool is also split over 'hyp'); and 2
    pairs with `adaptive` (fit_adaptive's two passes on the mesh)."""
    want = no_mesh_batch
    if name == "adaptive_2x2":
        want = tshard.run_benchmark_batch(
            R.batch_pairs()[:2], mt.MultiHConfig(**R.TINY), seed=3,
            adaptive=True, device="cpu")
    for rank in range(WORLD):
        got = load(ranks_dir, f"batch_{name}", rank)
        for field, a in want._asdict().items():
            assert got[field].dtype == a.dtype, field
            np.testing.assert_array_equal(got[field], a,
                                          err_msg=f"rank {rank} {field}")


def test_sharded_fit_mixed_equals_batch(ranks_dir):
    """sharded_fit_mixed of 2 pairs on the (2, 2) mesh against
    batched_fit_mixed without a mesh, every leaf bit for bit."""
    cfg_h, cfg_f = R.mixed_configs()
    ref = R._numpy(tshard.batched_fit_mixed(cfg_h, cfg_f, device="cpu")(
        *R.mixed_batch(), [torch.Generator().manual_seed(i) for i in (0, 1)]))
    assert int(ref["active"][0].sum()) >= 2
    for rank in range(WORLD):
        got = load(ranks_dir, "mixed_2x2", rank)
        assert got.keys() == ref.keys()
        for k, a in ref.items():
            np.testing.assert_array_equal(got[k], a, err_msg=f"{rank} {k}")


# ---------------------------------------------------------------------------
# window_range against the JAX sampler
# ---------------------------------------------------------------------------

_jax_windowed = jax.jit(jsamp.windowed_quadruples, static_argnums=(5, 6),
                        static_argnames=("window_range",))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_windowed_quadruples_window_range_matches_jax(rng, n_shards):
    """Each shard's window range against JAX's windowed_quadruples with
    the same window_range, on its own draws replayed, bit for bit."""
    block, nb, s = 64, 4, 4 * 96
    x1, x2, valid = morton_scene(rng, nb * block, invalid=25)
    ji, _ = _knn_windowed(jnp.asarray(x1), jnp.asarray(valid), 6, block)
    key = jax.random.key(8)
    nw = nb // n_shards
    for d in range(n_shards):
        ref = np.asarray(_jax_windowed(
            key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), ji,
            s, block, window_range=(d * nw, nw)))
        got = tsamp.windowed_quadruples(
            KeyWindowDraws(key), 0, t(x1), t(x2), t(valid),
            t(np.asarray(ji)), s, block, window_range=(d * nw, nw)).numpy()
        assert got.shape == (32, s // n_shards)
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# the 'pt' (point) axis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pt_single():
    """The port's unsharded fit of each 'pt' case."""
    out = {}
    for case in R.PT_CASES:
        (x1, x2, valid), cfg, key, cs = R.pt_inputs(case)
        out[case] = (mt.fit(x1, x2, valid, torch.Generator().manual_seed(key),
                            cfg, device="cpu"), cs)
    return out


@pytest.mark.parametrize("ranks,case", R.PT_RUNS,
                         ids=[f"pt{len(r)}-{c}" for r, c in R.PT_RUNS])
def test_pt_sharded_fit_equals_fit(ranks_dir, pt_single, ranks, case):
    """pt_sharded_fit on 4 and 2 gloo ranks (2 and 4 Morton blocks a
    rank) against the port's unsharded fit with the same generator seed
    (tests/test_sharding.py:338-377 at a cut-down N): labels, active,
    n_hypotheses_ok and n_far_dropped exact on every rank, energy within
    rtol 1e-3, misclassification under 2% (the fundamental model: within
    2.0 pp of the reference's 32-key mean, REF_MEAN_FMODEL); also with the
    direct refit (refit_moments=False), the fundamental model and the
    exact graph (with and without far edges past the far list's
    capacity)."""
    ref, cs = pt_single[case]
    k = R.PT["max_labels"]
    for rank in ranks:
        got = load(ranks_dir, f"pt{len(ranks)}_{case}", rank)
        np.testing.assert_array_equal(got["labels"], ref.labels.numpy(),
                                      err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["active"], ref.active.numpy())
        np.testing.assert_array_equal(got["n_hypotheses_ok"],
                                      ref.n_hypotheses_ok.numpy())
        np.testing.assert_array_equal(got["n_far_dropped"],
                                      ref.n_far_dropped.numpy())
        np.testing.assert_allclose(got["energy"], ref.energy.numpy(),
                                   rtol=1e-3)
        err = evaluation.misclassification_error(
            got["labels"][:cs.n_points], cs.gt_labels, k)
        if case == "fmodel":
            assert err <= REF_MEAN_FMODEL + 2.0, err
        else:
            assert err < 2.0, err


def test_pt_exact_cut_drops_far_edges(pt_single):
    """The "exact_cut" case's far list overflows its capacity, so the
    sharded fits above hold the capacity cut; "exact" has far edges but
    none dropped."""
    assert int(pt_single["exact_cut"][0].n_far_dropped) > 0
    assert int(pt_single["exact"][0].n_far_dropped) == 0


def test_pt_f_pieces_equal_unsharded(ranks_dir):
    """The F model's split weights (`_split_weights`: the Morton median
    from the local cumulative count and the members of the ranks before,
    the flow means and covariance summed over the axis, the quartile cuts
    on the gathered projections) and a union merge that fires (motion
    1's members split between two slots) on each rank of the 4-rank
    mesh, against the same functions without a shard: the rank's columns
    of the split weights, the merged F's and active bit-equal, and the
    merge's float64 scores (minus each pair's data-cost increase, under a
    label cost that lets every covering pair through) within rtol
    1e-12."""
    cfg = mt.MultiHConfig(**R.PT_CASES["fmodel"][0])
    ref = R.pt_f_pieces(None, cfg)
    assert ref["active"].sum() == 3  # slot 3 merged into slot 0
    n_own = cfg.max_points // WORLD
    for rank in range(WORLD):
        got = load(ranks_dir, "pt4_f_pieces", rank)
        own = slice(rank * n_own, (rank + 1) * n_own)
        np.testing.assert_array_equal(got["split"], ref["split"][:, own])
        np.testing.assert_array_equal(got["Hs"], ref["Hs"])
        np.testing.assert_array_equal(got["active"], ref["active"])
        finite = np.isfinite(ref["score"])
        assert finite.any()
        np.testing.assert_array_equal(np.isfinite(got["score"]), finite)
        np.testing.assert_allclose(got["score"][finite],
                                   ref["score"][finite], rtol=1e-12)


def test_pt_gate_refused(ranks_dir):
    """pt_sharded_fit raises ValueError where the reference asserts
    (sharding.py:93-99): 512 points are not a multiple of agree_block 256
    times 4 ranks."""
    for rank in range(WORLD):
        msg = str(load(ranks_dir, "pt4_gate", rank)["refused"])
        assert "multiple of agree_block*npt=256*4" in msg


def test_pt_windowed_sweeps_equal_unsharded(ranks_dir):
    """Each rank's window band (its own blocks' rows) equals the whole
    far-free band's, and the plain windowed sweeps with a halo exchange
    a sweep -- mean-field (mrf_kernel.mean_field_windowed) and red-black
    ICM a half-sweep a call (icm_windowed) -- equal the unsharded plain
    versions on the rank's own blocks, bit for bit."""
    from multih_tpu_torch.models import labeling as tlab
    from multih_tpu_torch.ops.kernels import mrf_kernel as tmrf

    c = R.PT_SWEEPS
    x1, valid, q0, base, starts, inv_t = (torch.from_numpy(a) for a in
                                          R.pt_sweep_inputs())
    nbr, w = tlab.knn_graph_windowed(x1, valid, 6, c["block"])
    band = tlab.build_banded_adjacency(nbr, w, c["block"],
                                       far_capacity=0).band
    q = tmrf.mean_field_fused_reference(q0, base, band, inv_t, 0.7).numpy()
    lab = tmrf.icm_fused_reference(starts, base, band, 2, 0.7).numpy()
    n_own, nb_own = c["n"] // WORLD, c["n"] // WORLD // c["block"]
    assert (lab != starts.numpy()).any()  # the sweeps move labels
    for rank in range(WORLD):
        got = load(ranks_dir, "pt4_sweeps", rank)
        own = slice(rank * n_own, (rank + 1) * n_own)
        np.testing.assert_array_equal(
            got["band"][1:-1], band[rank * nb_own:(rank + 1) * nb_own])
        assert not got["band"][[0, -1]].any()  # the halo rows are zero
        np.testing.assert_array_equal(got["q"], q[:, own])
        np.testing.assert_array_equal(got["labels"], lab[:, own])


def test_pt_mesh_of_one_rank_equals_fit():
    """A 'pt' mesh of one rank (no process group) runs the sharded code
    path with empty halos and identity sums: every output equals the
    unsharded fit's bit for bit."""
    (x1, x2, valid), cfg, key, _ = R.pt_inputs("plain")
    m = tshard.make_pt_mesh(device="cpu")
    assert m.shape == {"pt": 1}
    got = tshard.pt_sharded_fit(cfg, m)(x1, x2, valid,
                                        torch.Generator().manual_seed(key))
    ref = mt.fit(x1, x2, valid, torch.Generator().manual_seed(key), cfg,
                 device="cpu")
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_pt_window_neighbour_list(monkeypatch):
    """The window band's neighbour list (what K4 / K5 read on a 'pt'
    rank), built by the list's plain version on a one-rank mesh: one
    row a window point, its own rows the whole band's lists shifted by
    the halo block, the halo rows empty."""
    from multih_tpu_torch.models import labeling as tlab
    from multih_tpu_torch.ops.kernels import mrf_kernel as tmrf

    monkeypatch.setattr(tmrf, "band_list", tmrf.band_list_reference)
    c = R.PT_SWEEPS
    x1, valid = (torch.from_numpy(a) for a in R.pt_sweep_inputs()[:2])
    nbr, w = tlab.knn_graph_windowed(x1, valid, 6, c["block"])
    full = tmrf.band_list_reference(tlab.build_banded_adjacency(
        nbr, w, c["block"], far_capacity=0).band)
    shard = tlab.PointShard(tshard.make_pt_mesh(device="cpu"), c["n"],
                            c["block"])
    win = tlab.build_window_adjacency(nbr, w, shard, neighbour_list=True).nbr
    own = slice(c["block"], c["block"] + c["n"])
    assert win.cols.shape == (c["n"] + 2 * c["block"], 3 * c["block"])
    assert torch.equal(win.cnt[own], full.cnt)
    used = torch.arange(3 * c["block"])[None, :] < full.cnt[:, None]
    assert torch.equal(torch.where(used, win.cols[own] - c["block"], 0),
                       full.cols)
    assert torch.equal(win.ws[own], full.ws)
    assert int(win.cnt[:c["block"]].sum() + win.cnt[-c["block"]:].sum()) == 0
