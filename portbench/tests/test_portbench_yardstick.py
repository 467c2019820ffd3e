"""The benchmark's own yardstick: the frozen scene generators, the
roofline arithmetic, the trace's reductions and the reference."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import roofline, scenes
from portbench import trace as tr
from portbench.reference import common, motion, plane


@pytest.mark.parametrize("args", [
    (300, 2, 0.05, 0.3, 101, {}), (600, 5, 0.30, 0.5, 109, {}),
    (450, 3, 0.15, 0.5, 122, {"overlap": 0.5}),
    (520, 4, 0.15, 0.5, 121, {"clustered": False})])
def test_plane_scene_equals_the_ports(args):
    from multih_tpu_torch.utils import data

    n, p, o, s, seed, kw = args
    cs, Hs = data.synthetic_scene(n, p, o, s, seed=seed, **kw)
    got = scenes.plane_scene(n, p, o, s, seed, **kw)
    for a, b in ((got.x1, cs.x1), (got.x2, cs.x2), (got.gt, cs.gt_labels),
                 (got.models, Hs)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("args", [(400, 2, 0.10, 0.0, 201),
                                  (500, 3, 0.40, 0.5, 208),
                                  (700, 5, 0.15, 0.3, 220)])
def test_motion_scene_equals_the_ports(args):
    from multih_tpu_torch.utils import data

    cs, Fs = data.synthetic_motion_scene(*args[:4], seed=args[4])
    got = scenes.motion_scene(*args)
    for a, b in ((got.x1, cs.x1), (got.x2, cs.x2), (got.gt, cs.gt_labels),
                 (got.models, Fs)):
        np.testing.assert_array_equal(a, b)


def test_pool_sizes_do_not_depend_on_the_seed():
    spec = {"generator": "plane", "n_points": [300, 512],
            "n_models": [2, 6], "outlier_rate": [0.1, 0.5],
            "noise_px": [0.3, 1.0]}
    a = scenes.make_pool(spec, 12, 7)
    b = scenes.make_pool(spec, 12, 3000000007)
    c = scenes.make_pool(spec, 12, 7)

    def sizes(pool):
        return sorted((s.x1.shape[0], s.models.shape[0]) for s in pool)

    assert sizes(a) == sizes(b)
    assert not np.array_equal(a[0].x1, b[0].x1)
    assert all(np.array_equal(x.x1, y.x1) for x, y in zip(a, c))
    rows = scenes.pool_sizes(spec, 64)
    assert {r[1] for r in rows} == {2, 3, 4, 5, 6}
    assert min(r[0] for r in rows) == 300 and max(r[0] for r in rows) == 512
    assert {r[2] for r in rows} == {0.1, 0.2, 0.3, 0.4, 0.5}


# PERF.md's kernel table: each kernel's bound (ms) at its shapes
@pytest.mark.parametrize("kernel,shape,ms,by", [
    ("inlier_counts", dict(s=2051, n=512, kind="symmetric"), 0.00063,
     "operations"),
    ("inlier_counts", dict(s=102400, n=1280, kind="transfer"), 0.0391,
     "operations"),
    ("inlier_counts", dict(s=2051, n=512, kind="f_sampson"), 0.00058,
     "operations"),
    ("dlt_4pt", dict(s=512), 0.00002, "bytes"),
    ("dlt_4pt", dict(s=51200), 0.0018, "bytes"),
    ("eig9_smallest", dict(c=256), 0.00005, "operations"),
    ("eig9_smallest", dict(c=16), 0.000003, "operations"),
    ("band_list", dict(nb=2, block=256), 0.00141, "bytes"),
    ("band_list", dict(nb=80, block=128), 0.01410, "bytes"),
    ("window_gather", dict(nb=80, rows=384, c=8, t=1280), 0.00139, "bytes"),
    ("window_gather", dict(nb=80, rows=384, c=15, t=1600), 0.0030, "bytes"),
])
def test_bounds_reproduce_the_kernel_table(kernel, shape, ms, by):
    work = roofline.WORK[kernel](**shape)
    got = roofline.bound_s(*work) * 1e3
    digits = len(f"{ms:.10f}".rstrip("0").split(".")[1])
    assert round(got, digits) == pytest.approx(ms, rel=1e-9, abs=1e-12)
    assert roofline.bound_by(*work) == by


def test_mufu_bound_of_the_fast_reciprocal():
    # the table's K1 rows: the reciprocals at the MUFU rate
    b, o, m = roofline.inlier_counts(2051, 512, "symmetric")
    assert round(m / roofline.PEAK_MUFU_S * 1e3, 5) == 0.00050
    assert roofline.inlier_counts(2051, 512, "symmetric", False)[2] == 0


def test_cpu_calls_launch_nothing():
    import torch

    a = {"Hs": torch.zeros(4, 3, 3), "x1": torch.zeros(8, 2)}
    assert tr._shape("inlier_counts_padded", a) is None
    assert tr._shape("homography_4pt_gt", {"gt": torch.zeros(32, 4)}) is None
    assert tr._shape("smallest_eigvec_9x9_batch",
                     {"ata": torch.zeros(2, 9, 9)}) is None


def test_kernel_symbols_are_matched_whole():
    assert tr.kernel_of_event("void (anonymous namespace)::count_kernel"
                              "<4>(Args)") == "inlier_counts"
    assert tr.kernel_of_event("mf_front_grid(float const*)") == \
        "mean_field_fused_front"
    assert tr.kernel_of_event("mf_grid(float const*)") == "mean_field_fused"
    assert tr.kernel_of_event("void at::native::elementwise_kernel") is None


def test_trace_busy_idle_and_gaps():
    t = tr.Trace(pairs=2, host_s=1.0, window=(0.0, 1.0),
                 device=[("a", 0.1, 0.3), ("b", 0.2, 0.4),
                         ("count_kernel", 0.6, 0.7), ("c", 0.95, 1.2)],
                 ranges=[("aten::copy_", 0.4, 0.6), ("cudaGraphLaunch",
                                                     0.7, 0.9)],
                 annotations=[("portbench.fit", 0.0, 1.0),
                              ("pearl", 0.35, 0.65)])
    assert t.busy_intervals() == [(0.1, 0.4), (0.6, 0.7), (0.95, 1.0)]
    assert t.busy_s() == pytest.approx(0.45)
    assert t.kernel_device_s() == {"inlier_counts": pytest.approx(0.1)}
    gaps = dict(t.idle_gaps())
    assert gaps["pearl | aten::copy_"] == pytest.approx(0.2)
    assert gaps["portbench.fit | cudaGraphLaunch"] == pytest.approx(0.25)
    assert gaps["portbench.fit | no op"] == pytest.approx(0.1)
    assert sum(gaps.values()) == pytest.approx(1.0 - 0.45)


def test_misclassification_matching():
    gt = np.array([1, 1, 1, 2, 2, 0, 0, -1])
    k = 16
    assert common.misclassification_pct(np.array([5, 5, 5, 3, 3, k, k, k]),
                                        gt, k) == 0.0
    # one point of plane 2 put in plane 1's label; one outlier labelled
    pred = np.array([5, 5, 5, 5, 3, k, 3, k])
    assert common.misclassification_pct(pred, gt, k) == \
        pytest.approx(100 * 2 / 7)
    assert common.misclassification_pct(np.full(8, k), gt, k) == \
        pytest.approx(100 * 5 / 7)


def test_plane_reference_refit_is_exact_on_clean_points():
    s = scenes.plane_scene(300, 1, 0.0, 0.0, 5)
    w = np.ones(300)
    H = plane.refit(s.x1.astype(np.float64), s.x2.astype(np.float64), w)
    assert np.sqrt(plane.residual(H, s.x1, s.x2).max()) < 1e-3
    Ht = s.models[0] / np.linalg.norm(s.models[0])
    assert min(np.abs(H - Ht).max(), np.abs(H + Ht).max()) < 1e-5


def test_motion_reference_refit_is_exact_on_clean_points():
    s = scenes.motion_scene(300, 1, 0.0, 0.0, 5)
    F = motion.refit(s.x1.astype(np.float64), s.x2.astype(np.float64),
                     np.ones(300))
    assert np.sqrt(motion.residual(F, s.x1, s.x2).max()) < 1e-3
    assert abs(np.linalg.det(F)) < 1e-12


@pytest.mark.parametrize("readings,fast", [
    ([2.8, 2.8, 2.1, 2.1], True), ([2.1, 2.9, 2.1, 2.1], True),
    ([2.8] * 1000, False)])
def test_settle_waits_for_the_fast_state(monkeypatch, readings, fast):
    from portbench import launch_state

    it = iter(readings)

    class Probe:
        def __init__(self, device):
            pass

        def read(self):
            return next(it)

    monkeypatch.setattr(launch_state, "Probe", Probe)
    monkeypatch.setattr(launch_state, "EVERY_S", 0.001)
    monkeypatch.setattr(launch_state, "LIMIT_S", 0.2)
    calls = []
    got = launch_state.settle(lambda: calls.append(1), None)
    assert got["fast"] is fast and got["calls"] == len(calls) > 0
    assert (got["probe_ms"] < launch_state.FAST_MS) is fast
