"""The entry points around the port's fit: seed homographies (the
streaming warm start), the adaptive threshold and `run_stream`.

Against the JAX package: `estimate_tau` / `tau_from_members` on fixed
fit results built from numpy, the synthetic stream's frames, and one
seeded fit on replayed draws (the JAX fit's labels exactly). The rest
are the JAX package's own cases run on the port alone (tests/
test_streaming_features.py, tests/test_pipeline.py::TestAdaptiveTau),
on the CPU, with agree_block=128 where the JAX tests fit 256 points, so
the fits take the banded labeling (N a multiple >= 2 of agree_block);
at the default agree_block of 256 they would take the gather path,
which tests/test_torch_gather.py holds to the JAX package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multih_tpu
from multih_tpu.models import pipeline as jpipe
from multih_tpu.utils import streaming as jstream

import multih_tpu_torch as mt
from multih_tpu_torch.models import pipeline as tpipe
from multih_tpu_torch.utils import data as tdata
from multih_tpu_torch.utils import evaluation
from multih_tpu_torch.utils import streaming as tstream
from test_torch_windowed import FitReplayDraws

torch.set_num_threads(1)


def cpu_gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# the adaptive threshold against the reference
# ---------------------------------------------------------------------------

def gt_result(cs, hs, k, n_pad):
    """A fit result of the scene's own models: labels from the ground
    truth (outliers and padding -> K), models normalized, the rest
    identities, inactive."""
    n = cs.n_points
    lab = np.full(n_pad, k, np.int32)
    lab[:n] = np.where(cs.gt_labels > 0, cs.gt_labels - 1, k)
    m = len(hs)
    models = np.tile(np.eye(3, dtype=np.float32), (k, 1, 1))
    models[:m] = hs / np.linalg.norm(hs, axis=(1, 2), keepdims=True)
    active = np.zeros(k, np.float32)
    active[:m] = 1.0
    return dict(labels=lab, homographies=models, active=active,
                support=np.zeros(k, np.float32),
                energy=np.float32(0), energy_trace=np.zeros(1, np.float32),
                n_hypotheses_ok=np.float32(0), n_far_dropped=np.int32(0))


@pytest.mark.parametrize("case", [
    dict(cfg={}, scene=(400, 3, 0.15, 1.0, 117)),              # ~6 px
    dict(cfg=dict(residual="transfer"), scene=(400, 3, 0.15, 1.0, 117)),
    dict(cfg={}, scene=(200, 2, 0.05, 0.2, 9)),                # the floor
    dict(cfg={}, scene=(400, 3, 0.15, 4.0, 3)),                # the cap
    dict(cfg=dict(min_inliers=500), scene=(400, 3, 0.15, 1.0, 117)),
    dict(cfg=dict(model="fundamental", residual="sampson"),
         scene=(400, 2, 0.1, 0.5, 4), motion=True),
], ids=["homography", "transfer", "floor", "cap", "too_few_members",
        "fundamental"])
def test_estimate_tau_matches_reference(case):
    cfg = mt.MultiHConfig(max_points=512, **case["cfg"])
    make = (tdata.synthetic_motion_scene if case.get("motion")
            else tdata.synthetic_scene)
    n, m, out, noise, seed = case["scene"]
    cs, models = make(n, m, out, noise, seed=seed)
    x1, x2, valid = mt.pad_points(cs.x1, cs.x2, None, 512)
    res = gt_result(cs, models, cfg.max_labels, 512)
    jcfg = multih_tpu.MultiHConfig(**dataclasses.asdict(cfg))
    want = float(jpipe.estimate_tau(
        jpipe.FitResult(**{k: jnp.asarray(v) for k, v in res.items()}),
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), jcfg))
    got = tpipe.estimate_tau(
        tpipe.FitResult(**{k: torch.as_tensor(v) for k, v in res.items()}),
        x1, x2, valid, cfg)
    assert got.dim() == 0 and got.device.type == "cpu"
    # F's Sampson residuals agree to ~1e-4 relative across the packages
    # (the epipolar lines round differently), the homography ones ~1e-6
    np.testing.assert_allclose(float(got), want,
                               rtol=1e-4 if case.get("motion") else 1e-5)
    if case["cfg"].get("min_inliers"):
        assert float(got) == cfg.inlier_threshold


def test_tau_from_members_matches_reference(rng):
    r = rng.exponential(2.0, 300).astype(np.float32)
    member = rng.uniform(size=300) > 0.4
    for kw in (dict(), dict(floor=0.5, cap=2.5), dict(floor=5.0)):
        cfg = mt.MultiHConfig(min_inliers=10)
        want = jpipe.tau_from_members(
            jnp.asarray(r), jnp.asarray(member),
            multih_tpu.MultiHConfig(**dataclasses.asdict(cfg)),
            jnp.float32, **kw)
        got = tpipe.tau_from_members(torch.from_numpy(r),
                                     torch.from_numpy(member), cfg, **kw)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# seeded fits
# ---------------------------------------------------------------------------

# tests/test_streaming_features.py::TestWarmStart's config, agree_block
# 128 (see the module docstring)
WARM = dict(max_points=256, n_hypotheses=24, n_candidates=24, max_labels=6,
            progressive_rounds=2, label_cost=8.0, min_inliers=8,
            agree_block=128)


def warm_scene():
    """240 points on 4 planes, the true planes (normalized) and two
    identities as seeds, the identities masked off."""
    cs, hs = tdata.synthetic_scene(240, 4, 0.3, 0.5, seed=21)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 256)
    hn = hs / np.linalg.norm(hs, axis=(1, 2), keepdims=True)
    seeds = np.concatenate([hn, np.tile(np.eye(3, dtype=np.float32),
                                        (2, 1, 1))]).astype(np.float32)
    ok = np.array([1, 1, 1, 1, 0, 0], np.float32)
    return (x1, x2, valid), gt, seeds, ok


def test_seeded_fit_matches_reference():
    """The port's seeded fit on the JAX fit's replayed draws gives the
    JAX seeded fit's labels exactly."""
    pts, _, seeds, ok = warm_scene()
    jcfg = multih_tpu.MultiHConfig(**WARM)
    key = jax.random.key(0)
    jr = jax.device_get(multih_tpu.make_fit_seeded(jcfg)(
        *pts, key, jnp.asarray(seeds), jnp.asarray(ok)))
    tcfg = mt.MultiHConfig.from_dict(dataclasses.asdict(jcfg))
    tr = mt.make_fit_seeded(tcfg, device="cpu")(
        *pts, FitReplayDraws(key, jcfg.progressive_rounds), seeds, ok)
    np.testing.assert_array_equal(tr.labels.numpy(), np.asarray(jr.labels))
    np.testing.assert_array_equal(tr.active.numpy(), np.asarray(jr.active))
    assert float(tr.n_hypotheses_ok) == float(jr.n_hypotheses_ok)


def test_seeds_rescue_tiny_budget():
    """With the true planes as seeds, a 24-hypothesis fit solves a
    4-plane scene at least as well as the cold fit of the same draws
    (tests/test_streaming_features.py's case on the port)."""
    pts, gt, seeds, ok = warm_scene()
    cfg = mt.MultiHConfig(**WARM)
    rc = mt.make_fit(cfg, device="cpu")(*pts, cpu_gen(0))
    rs = mt.make_fit_seeded(cfg, device="cpu")(*pts, cpu_gen(0), seeds, ok)
    e_cold = evaluation.misclassification_error(rc.labels.numpy(), gt, 6)
    e_seed = evaluation.misclassification_error(rs.labels.numpy(), gt, 6)
    assert e_seed < 5.0, e_seed
    assert e_seed <= e_cold
    assert int(rs.active.sum()) == 4


def test_non_finite_seeds_are_masked():
    """A NaN seed never enters: the fit equals the one without it."""
    pts, _, seeds, ok = warm_scene()
    cfg = mt.MultiHConfig(**WARM)
    bad = seeds.copy()
    bad[4] = np.nan
    ok_all = np.ones(6, np.float32)
    f = mt.make_fit_seeded(cfg, device="cpu")
    a = f(*pts, cpu_gen(1), bad, ok_all)
    b = f(*pts, cpu_gen(1), seeds, np.r_[ok_all[:4], 0.0, 1.0])
    assert torch.equal(a.labels, b.labels)
    assert bool(torch.isfinite(a.homographies).all())


# ---------------------------------------------------------------------------
# the adaptive fit (tests/test_pipeline.py::TestAdaptiveTau on the port)
# ---------------------------------------------------------------------------

def test_adaptive_recovers_from_wrong_static_tau():
    """The noise-1px scene is unsolvable at the default tau=3 but solves
    at the estimated tau ~6."""
    cfg = mt.MultiHConfig(max_points=512, n_hypotheses=2048)
    cs, _ = tdata.synthetic_scene(400, 3, 0.15, 1.0, seed=117)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 512)
    res, tau = mt.make_fit_adaptive(cfg, device="cpu")(x1, x2, valid,
                                                       cpu_gen(0))
    assert tau.dim() == 0 and 4.5 < float(tau) < 7.5, float(tau)
    err = evaluation.misclassification_error(res.labels.numpy(), gt,
                                             cfg.max_labels)
    assert err < 3.0, err
    assert int(res.active.sum()) == 3


def test_adaptive_low_noise_hits_the_floor():
    cfg = mt.MultiHConfig(max_points=256, n_hypotheses=1024,
                          agree_block=128)
    cs, _ = tdata.synthetic_scene(200, 2, 0.05, 0.2, seed=9)
    x1, x2, valid = mt.pad_points(cs.x1, cs.x2, None, 256)
    # a (probe, fit) pair of draw sources, as the reference splits its key
    _, tau = mt.fit_adaptive(x1, x2, valid, (cpu_gen(0), cpu_gen(1)), cfg,
                             device="cpu")
    assert abs(float(tau) - 3.0) < 0.5, float(tau)


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

def test_synthetic_stream_equals_reference():
    kw = dict(n_frames=3, n_points=120, n_planes=2, seed=3)
    for a, b in zip(tstream.SyntheticStream(**kw),
                    jstream.SyntheticStream(**kw)):
        np.testing.assert_array_equal(a.x1, b.x1)
        np.testing.assert_array_equal(a.x2, b.x2)
        np.testing.assert_array_equal(a.gt_labels, b.gt_labels)
        assert a.name == b.name


def test_run_stream_fits_frames():
    cfg = mt.MultiHConfig(max_points=256, n_hypotheses=512, max_labels=8,
                          n_candidates=64, agree_block=128)
    st = tstream.SyntheticStream(n_frames=4, n_points=200, n_planes=2,
                                 seed=3)
    stats = tstream.run_stream(st, cfg, budget_ms=1e9, device="cpu")
    assert stats.frames == 4
    assert stats.mean_planes >= 1.5, stats
    assert stats.mean_ms > 0 and stats.fps > 0
    assert stats.meets_budget()


def test_run_stream_skips_oversized_frames():
    """A frame past cfg.max_points is skipped with a warning, not fatal."""
    cfg = mt.MultiHConfig(max_points=64, n_hypotheses=128, n_candidates=32,
                          max_labels=4, label_cost=2.0, min_inliers=6,
                          agree_block=32)
    small, _ = tdata.synthetic_scene(48, 1, 0.0, 0.3, seed=3)
    big, _ = tdata.synthetic_scene(200, 1, 0.0, 0.3, seed=4)
    frames = [small, big, small._replace(name="again")]
    stats = tstream.run_stream(frames, cfg, pipeline_depth=1,
                               warm_start=False, device="cpu")
    assert stats.frames == 2
    assert tstream.run_stream([big], cfg, device="cpu").frames == 0


def test_run_stream_needs_a_card_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    frames = [tdata.synthetic_scene(48, 1, 0.0, 0.3, seed=3)[0]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstream.run_stream(frames)
    with pytest.raises(ValueError, match="upload"):
        tstream.run_stream(frames, upload="later", device="cpu")
    z = np.zeros((512, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.make_fit_seeded(mt.MultiHConfig())(
            z, z, np.ones(512, np.float32), torch.Generator(),
            np.zeros((8, 3, 3), np.float32), np.zeros(8, np.float32))


def test_directory_stream_reads_sorted_files(tmp_path):
    from scipy.io import savemat

    for i in range(3):
        cs, _ = tdata.synthetic_scene(50, 1, 0.0, 0.0, seed=i)
        tdata.save_correspondences_txt(str(tmp_path / f"frame{i:03d}.txt"),
                                       cs)
    # an AdelaideRMF .mat: 6 x N homogeneous [x; y; 1; x'; y'; 1]
    one = np.ones((1, 50))
    savemat(str(tmp_path / "frame003.mat"), {
        "data": np.concatenate([cs.x1.T, one, cs.x2.T, one]),
        "label": cs.gt_labels})
    frames = list(tstream.DirectoryStream(str(tmp_path)))
    assert [f.name for f in frames] == ["frame000", "frame001", "frame002",
                                        "frame003"]
    assert frames[0].n_points == 50
    assert frames[0].gt_labels is not None
    np.testing.assert_allclose(frames[3].x2, cs.x2, rtol=1e-6)
    np.testing.assert_array_equal(frames[3].gt_labels, cs.gt_labels)


def test_directory_stream_skips_malformed_frames(tmp_path):
    cs, _ = tdata.synthetic_scene(50, 1, 0.0, 0.0, seed=1)
    tdata.save_correspondences_txt(str(tmp_path / "a.txt"), cs)
    (tmp_path / "b.txt").write_text("garbage not numbers\n1 2\n")
    (tmp_path / "c.txt").write_text("1 2 3 nan\n" * 20)
    tdata.save_correspondences_txt(str(tmp_path / "d.txt"), cs)
    st = tstream.DirectoryStream(str(tmp_path))
    frames = list(st)
    assert [f.name for f in frames] == ["a", "d"]
    assert len(st.skipped) == 2
