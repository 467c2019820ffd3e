"""The card checks that chip_smoke.py, the `cuda`-marked tests and the
tools share: the inputs at the main paths' shapes, each kernel held to
its plain version, and the launch counters.

Each `*_parity` function runs one hand-written kernel on card tensors,
holds it to its plain version (the tolerances are written here once),
raises AssertionError on a miss and returns what it measured. The
builders make the kernels' inputs the way the fits make them, or take
them from a fit on the card. Nothing here times anything: a kernel's
time is tools/torch_kernel_ab.py's.

This module imports no JAX. The port is imported inside the functions,
so that a tool may put another tree's `multih_tpu_torch` first on the
path before it builds inputs here.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import subprocess

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the card and the counters
# ---------------------------------------------------------------------------

def sh(cmd: list[str]) -> str:
    """stdout of a short command (stderr appended on failure)."""
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    return (proc.stdout + ("" if proc.returncode == 0 else proc.stderr)).strip()


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi."""
    return sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_launches(fn, calls: int = 10, tries: int = 5):
    """(launches a call, the device events of one call) of fn, from
    torch.profiler over `calls` warm calls: its device events but the
    user annotations (ranges, not launches). A profile can miss device
    events (a short window may come back empty), never add one: a session
    in which some event name does not occur a multiple of `calls` times
    lost events and is taken again, up to `tries` times; (None, []) when
    none came back whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
        counts = collections.Counter(names)
        if names and all(c % calls == 0 for c in counts.values()):
            return len(names) // calls, sorted(
                n for n, c in counts.items() for _ in range(c // calls))
    return None, []


def launches_per_call(fn) -> int:
    """`cuda_launches`' count, or AssertionError where the profiler lost
    events in every session."""
    n, _ = cuda_launches(fn)
    check(n is not None, "the profiler lost device events in every session")
    return n


def graph_ops(fn) -> int:
    """The device ops (kernel, copy and set nodes) one call of fn
    enqueues: the nodes of a CUDA graph that captures it
    (utils/aot._graph_ops). A count that no profile can lose events
    from."""
    from multih_tpu_torch.utils import aot

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
        before = aot._graph_ops(side)
        fn()
        return aot._graph_ops(side) - before


def wrappers() -> dict:
    """Each hand-written kernel's wrapper, which counts its launches."""
    from multih_tpu_torch.ops.kernels import (accept_kernel, dlt_kernel,
                                              eig_kernel, gather_kernel,
                                              mrf_kernel, residual_kernel)

    return {
        "inlier_counts": residual_kernel.inlier_counts_padded,
        "dlt_4pt": dlt_kernel.homography_4pt_gt,
        "eig9_smallest": eig_kernel.smallest_eigvec_9x9_batch,
        "moment_refit": eig_kernel.moment_refit_batch,
        "f_accept_step": accept_kernel.f_accept_fallback,
        "mean_field_fused": mrf_kernel.mean_field_fused,
        "icm_fused": mrf_kernel.icm_fused,
        "mean_field_fused_front": mrf_kernel.mean_field_fused_front,
        "band_list": mrf_kernel.band_list,
        "window_gather": gather_kernel.window_gather,
    }


def count_launches(label: str, expect, fn, quiet: bool = False):
    """Run fn() with every kernel's launch count set to 0 just before and
    read just after; fail unless each kernel in `expect` launched. K1's
    launches are split by residual kind: `inlier_counts` counts the
    homography kinds, `inlier_counts_f` the epipolar (f_) kinds; the
    moment refit's by model: `moment_refit` the homography refits,
    `moment_refit_f` the fundamental ones; `f_accept_step` counts the
    accept fallback's ends (its K5 launches count as K5's)."""
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    k1 = ws["inlier_counts"]
    k1.kind_launches = {}
    refit = ws["moment_refit"]
    refit.model_launches = dict.fromkeys(refit.model_launches, 0)
    out = fn()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in ws.items()}
    f_kinds = {k: v for k, v in k1.kind_launches.items()
               if k.startswith("f_")}
    launches["inlier_counts_f"] = sum(f_kinds.values())
    launches["inlier_counts"] -= launches["inlier_counts_f"]
    launches["moment_refit"] = refit.model_launches["homography"]
    launches["moment_refit_f"] = refit.model_launches["fundamental"]
    if not quiet:
        print(f"kernel launches on the {label} path:", launches,
              "K1 by kind:", k1.kind_launches)
    for k in expect:
        check(launches[k] > 0, f"kernel {k} never launched on the {label} "
              f"path")
    return out, launches


# ---------------------------------------------------------------------------
# configs and scenes
# ---------------------------------------------------------------------------

def motion_cfg(npad: int):
    """The motion suite's config (tests/test_golden_parity.py:145-148)."""
    from multih_tpu_torch import MultiHConfig

    return MultiHConfig(max_points=npad, n_hypotheses=2048,
                        model="fundamental", residual="sampson")


def mixed_cfgs(npad: int):
    """The mixed goldens' configs (tests/test_golden_parity.py:217-223)."""
    from multih_tpu_torch import MultiHConfig

    cfg_h = MultiHConfig(max_points=npad, n_hypotheses=2048, max_labels=8)
    return cfg_h, dataclasses.replace(cfg_h, model="fundamental",
                                      residual="sampson")


def stress_cfg():
    """bench.py::_stress_cfg(10240, 102400, n_candidates=256,
    max_labels=16), its values copied (bench.py imports JAX)."""
    from multih_tpu_torch import MultiHConfig

    return MultiHConfig(
        max_points=10240, n_hypotheses=102400, residual_chunk=4096,
        progressive_rounds=2, claims_per_round=8, verify_subsample=8,
        claim_subsample=8, pearl_iterations=5, window_sampling=True,
        rank_residual="transfer", agree_block=128, meanfield_iterations=4,
        icm_iterations=1, n_candidates=256, max_labels=16,
    )


def to(dev, *arrays):
    return [torch.from_numpy(np.asarray(a)).to(dev) for a in arrays]


def cpu_draws(seed):
    """Draws from a CPU generator: the same minimal samples for a CPU fit
    and a card fit."""
    from multih_tpu_torch.ops.sampling import TorchDraws

    return TorchDraws(torch.Generator().manual_seed(seed))


def suite_points(cs, n_pad, dev):
    """A scene's (x1, x2, valid) padded to n_pad, on `dev`."""
    from multih_tpu_torch import pad_points

    return to(dev, *pad_points(cs.x1, cs.x2, None, n_pad)[:3])


def motion_points(name, n_pad, dev):
    from multih_tpu_torch.utils import data

    return suite_points(data.motion_suite_scene(name), n_pad, dev)


def scene_points(n_points, n_pad, seed, dev):
    """The stress scene's recipe: 8 planes, 70% outliers, 0.5 px."""
    from multih_tpu_torch.utils import data

    cs, _ = data.synthetic_scene(n_points, 8, 0.7, 0.5, seed=seed)
    return suite_points(cs, n_pad, dev)


def stress_points(dev):
    """The stress scene (10k points) padded to 10240, on `dev`."""
    return scene_points(10000, 10240, 42, dev)


def golden_batch():
    """The 24 golden scenes and their taus."""
    from multih_tpu_torch.utils import data

    css = [data.suite_scene(row[0]) for row in data.SUITE]
    taus = [float(np.load(os.path.join(ROOT, "tests", "goldens",
                                       f"{cs.name}.npz"))["inlier_threshold"])
            for cs in css]
    return css, taus


def hv_inputs(cfg, x1, x2, valid):
    """The Morton-sorted points and sampling graph that fit() hands its
    hypothesize + verify stages on the windowed path (stress config:
    the windowed graph of positions and 2x motion)."""
    from multih_tpu_torch.models import labeling, pipeline

    perm = pipeline.morton_order(x1, valid)
    x1, x2, valid = x1[perm], x2[perm], valid[perm]
    feat = torch.cat([x1, cfg.sampling_motion_weight * (x2 - x1)], dim=1)
    nbr, _ = labeling.knn_graph_windowed(feat, valid, cfg.knn_k,
                                         cfg.agree_block)
    return x1, x2, valid, nbr


def windowed_problem(dev, n_points, n_pad, block, seed=42):
    """`scene_points`, Morton-sorted, with their windowed k-NN graph and
    its far-free band and neighbour list, as the fit builds them on the
    card."""
    from multih_tpu_torch.models import labeling, pipeline

    x1, x2, valid = scene_points(n_points, n_pad, seed, dev)
    perm = pipeline.morton_order(x1, valid)
    x1, x2, valid = x1[perm], x2[perm], valid[perm]
    nbr_idx, nbr_w = labeling.knn_graph_windowed(x1, valid, 6, block)
    adj = labeling.build_banded_adjacency(nbr_idx, nbr_w, block,
                                          far_capacity=0,
                                          neighbour_list=True)
    check(int(adj.n_dropped) == 0, "windowed graph with out-of-band edges")
    return x1, x2, valid, nbr_idx, adj


def sampler_rows(rng, s, dev):
    """(32, S) sampler rows (row 8q + c = channel c of quad point q: x1,
    y1, x2, y2, avail) of uniform quads and a noisy affine image, as the
    sampler hands them over (a transposed view, strides (1, 32)), with a
    repeated-point quad, collinear triples, duplicate points, padded
    points (avail 0) and quads ~0.01 px wide, whose triangle areas
    straddle the 1e-4 degeneracy threshold."""
    p1 = rng.uniform(0, 640, (s, 4, 2)).astype(np.float32)
    p2 = (p1 * 1.1 + rng.normal(0, 2.0, (s, 4, 2))).astype(np.float32)
    p1[5, 1] = p1[5, 0]
    p2[5, 1] = p2[5, 0]
    avail = np.ones((s, 4), np.float32)
    i = np.arange(s)
    p1[i % 7 == 1, 2] = (p1[i % 7 == 1, 0] + p1[i % 7 == 1, 1]) * 0.5
    p2[i % 11 == 2, 3] = p2[i % 11 == 2, 1]
    pad = np.flatnonzero(i % 13 == 3)
    avail[pad, rng.integers(0, 4, pad.size)] = 0.0
    tiny = i % 5 == 4
    base = rng.uniform(0, 640, (int(tiny.sum()), 1, 2)).astype(np.float32)
    p1[tiny] = base + rng.uniform(0, 0.02, (int(tiny.sum()), 4, 2))
    p2[tiny] = base + rng.uniform(0, 0.02, (int(tiny.sum()), 4, 2))
    rows = np.zeros((s, 4, 8), np.float32)
    rows[:, :, 0:2], rows[:, :, 2:4], rows[:, :, 4] = p1, p2, avail
    return torch.from_numpy(rows.reshape(s, 32)).to(dev).T


def normal_matrices(rng, c):
    """(C, 9, 9) DLT normal matrices of noisy 12-point samples, on the
    CPU."""
    from multih_tpu_torch.ops import geometry

    x1 = rng.uniform(-1, 1, (c, 12, 2))
    H = np.eye(3) + rng.normal(0, 0.1, (c, 3, 3))
    pr = np.concatenate([x1, np.ones((c, 12, 1))], 2) @ H.transpose(0, 2, 1)
    x2 = pr[..., :2] / pr[..., 2:3] + rng.normal(0, 0.01, (c, 12, 2))
    return geometry.dlt_normal_matrix(
        torch.from_numpy(x1.astype(np.float32)),
        torch.from_numpy(x2.astype(np.float32)))


# ---------------------------------------------------------------------------
# inputs taken from fits on the card
# ---------------------------------------------------------------------------

def affine_fit(dev):
    """The affine one-point fit (tests/test_pipeline.py::TestAffinePath's
    scene: 300 points, 2 planes, ground-truth affines) at the default
    config: run(affines=True) -> FitResult, with run.args, run.gt (the
    padded ground-truth labels) and run.cfg."""
    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import data, features

    cs, Hs = data.synthetic_scene(300, 2, 0.1, 0.3, seed=21)
    aff = features.affines_from_homographies(Hs, cs.gt_labels - 1, cs.x1,
                                             outlier_label=-1)
    cfg = mt.MultiHConfig(max_points=512)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 512)
    A = np.tile(np.eye(2, dtype=np.float32), (512, 1, 1))
    A[:cs.n_points] = aff
    args = to(dev, x1, x2, valid, A)
    gen = torch.Generator(device=dev)

    def run(affines=True):
        return mt.fit(*args[:3], gen.manual_seed(0), cfg,
                      affines=args[3] if affines else None)
    run.args, run.gt, run.cfg = args, gt, cfg
    return run


def captured_counts(run, s: int):
    """(Hs, x1, x2, valid, kind, thr) of the first K1 call of S=s
    hypotheses that run() makes, taken as handed over."""
    from multih_tpu_torch.ops.kernels import residual_kernel as rk

    seen = []
    count = rk.inlier_counts_padded

    def capture(Hs, x1, x2, valid, thr, kind="symmetric", **kw):
        if Hs.shape[0] == s and not seen:
            seen.append((Hs.clone(), x1.clone(), x2.clone(), valid.clone(),
                         kind, thr.clone()))
        return count(Hs, x1, x2, valid, thr, kind=kind, **kw)

    # the wrapper counts its launches under its module-level name
    capture.launches, capture.kind_launches = 0, {}
    rk.inlier_counts_padded = capture
    try:
        run()
    finally:
        rk.inlier_counts_padded = count
    check(len(seen) > 0, f"the fit made no count call of S={s}")
    return seen[0]


def affine_verify_pool(dev):
    """(Hs, x1, x2, valid, kind, thr) of the affine fit's verify count:
    its 2048 sampled + 3 claim hypotheses and its 512 one-point H's (one
    a point, the padded points' included, some of them non-finite)."""
    return captured_counts(affine_fit(dev), 2051 + 512)


def motion_fit(dev):
    """One motion fit on fm4_a at tau 3 on `dev` (CPU draws, key 0)."""
    from multih_tpu_torch import make_fit_tau

    return make_fit_tau(motion_cfg(512))(
        *motion_points("fm4_a", 512, dev), cpu_draws(0), 3.0)


def fit_refit_batch(fit, c, last, dev):
    """(moments, T1g, T2g) of the first (or the last) batch of c
    candidates that a fit on `dev` hands the moment refit: `fit`
    "homography" the default fit on easy2_a, "fundamental" the motion
    fit on fm4_a at tau 3, "mixed" the mixed fit on mx21_a at N=1024
    (its F refits; the last batch of 8 is the polish's)."""
    import multih_tpu_torch as mt
    from multih_tpu_torch.ops.kernels import eig_kernel
    from multih_tpu_torch.utils import data

    runs = {
        "homography": ("homography", lambda: mt.make_fit(
            mt.MultiHConfig(max_points=512))(
                *suite_points(data.suite_scene("easy2_a"), 512, dev),
                torch.Generator(device=dev).manual_seed(0))),
        "fundamental": ("fundamental", lambda: motion_fit(dev)),
        "mixed": ("fundamental", lambda: mt.make_fit_mixed(
            *mixed_cfgs(1024))(
                *suite_points(data.mixed_suite_scene("mx21_a"), 1024, dev),
                cpu_draws(0))),
    }
    model, run = runs[fit]
    seen = []
    refit = eig_kernel.moment_refit_batch

    def capture(mom, kind, T1g, T2g):
        if kind == model and mom.shape[0] == c:
            seen.append((mom.clone(), T1g.clone(), T2g.clone()))
        return refit(mom, kind, T1g, T2g)

    # the wrapper counts its launches under its module-level name
    capture.launches = 0
    capture.model_launches = dict.fromkeys(refit.model_launches, 0)
    eig_kernel.moment_refit_batch = capture
    try:
        run()
    finally:
        eig_kernel.moment_refit_batch = refit
    check(len(seen) > 0, f"the {fit} fit made no {model} refit of C={c}")
    return seen[-1 if last else 0]


def f_normal_matrices_of(mom):
    """The (C, 9, 9) F normal matrices the plain route assembles from a
    refit's moments, less the zero ones of labels without members (they
    have no eigenvector to hold)."""
    from multih_tpu_torch.ops import fmodel

    atas = fmodel._moments_to_ata_f(mom.reshape(-1, 6, 6))[0]
    atas = atas[atas.flatten(1).abs().amax(1) > 0].contiguous()
    check(atas.shape[0] > 0, "every normal matrix is zero")
    return atas


def accept_states(dev):
    """Every accept of one motion fit on fm4_a on `dev` (the f512 cell's
    K=16, L=17, N=512) as its kernel route is handed it: a list of
    (the fallback's arguments, relabel_energy, residuals)."""
    from multih_tpu_torch.models import pipeline
    from multih_tpu_torch.ops.kernels import accept_kernel

    states, plain_fns = [], []
    accept, fallback = pipeline._f_accept, accept_kernel.f_accept_fallback

    def take_plain(*args, **kw):
        # relabel_energy, residuals: the fit's closures
        plain_fns.append(args[9:11])
        return accept(*args, **kw)

    def take_state(*args):
        states.append(tuple(a.clone() if torch.is_tensor(a) else a
                            for a in args))
        return fallback(*args)

    # the wrapper counts its launches under its module-level name
    take_state.launches = 0
    pipeline._f_accept = take_plain
    accept_kernel.f_accept_fallback = take_state
    try:
        motion_fit(dev)
    finally:
        pipeline._f_accept = accept
        accept_kernel.f_accept_fallback = fallback
    check(len(states) == len(plain_fns) > 0, f"accept fallback: "
          f"{len(states)} kernel-route calls, {len(plain_fns)} accepts")
    return [(s, *p) for s, p in zip(states, plain_fns)]


# ---------------------------------------------------------------------------
# each kernel against its plain version
# ---------------------------------------------------------------------------

def count_parity(Hs, x1, x2, valid, thr, kind="symmetric", inliers=True,
                 **kw):
    """K1 (`inlier_counts_padded`, `kw` its options) against its plain
    version: one launch, float32 (S,) counts within +-2 of the plain
    counts and within 0.5 on average; with `inliers`, the plain version
    finds some. Returns (counts, the largest |dcount|)."""
    from multih_tpu_torch.ops.kernels import residual_kernel as rk

    ref = rk.inlier_counts_reference(Hs, x1, x2, valid, thr, kind)
    check(not inliers or float(ref.max()) > 0, f"count {kind}: no inliers")
    before = rk.inlier_counts_padded.launches
    got = rk.inlier_counts_padded(Hs, x1, x2, valid, thr, kind=kind, **kw)
    check(rk.inlier_counts_padded.launches == before + 1,
          f"count {kind}: not one launch")
    check(got.dtype == torch.float32 and got.shape == (Hs.shape[0],),
          f"count {kind}: {got.dtype} {tuple(got.shape)}")
    d = (got - ref).abs()
    check(float(d.max()) <= 2.0 and float(d.mean()) < 0.5,
          f"count {kind} {Hs.shape[0]}x{x1.shape[0]} {kw}: max "
          f"{float(d.max())} mean {float(d.mean())}")
    return got, float(d.max())


def dlt_parity(gt):
    """K2 (`homography_4pt_gt`) on (32, S) sampler rows against its plain
    version: one launch, ok equal bit for bit, every H finite; the H's
    within 5e-4 of the plain version's on the usable quads whose float32
    solve is well conditioned (plain float32 within 1e-4 of float64; on
    the rest no float32 solver holds 5e-4), and within 1e-6 of float64
    on every usable quad (the kernel solves in double). Returns (H's,
    ok, a dict of the counts and errors)."""
    from multih_tpu_torch.ops.kernels import dlt_kernel as dk

    before = dk.homography_4pt_gt.launches
    hs, ok = dk.homography_4pt_gt(gt)
    check(dk.homography_4pt_gt.launches == before + 1, "DLT: not one launch")
    ref_h, ref_ok = dk.homography_4pt_gt_reference(gt)
    ref64 = dk.homography_4pt_gt_reference(gt.double())[0]
    s = gt.shape[1]
    check(torch.equal(ok, ref_ok), f"DLT S={s}: ok differs from the plain "
          f"version's on {int((ok != ref_ok).sum())}")
    check(bool(torch.isfinite(hs).all()), f"DLT S={s}: a non-finite H")
    usable = ref_ok > 0
    e_plain = (ref_h.double() - ref64).abs().amax((1, 2))
    well = usable & (e_plain < 1e-4)
    ill = usable & ~well
    e = (hs - ref_h).abs().amax((1, 2))
    e64 = (hs.double() - ref64).abs().amax((1, 2))
    out = dict(usable=int(usable.sum()), well=int(well.sum()),
               ill=int(ill.sum()),
               err=float(e[well].max()) if well.any() else 0.0,
               err64=float(e64[usable].max()) if usable.any() else 0.0,
               err64_ill=float(e64[ill].max()) if ill.any() else 0.0,
               err64_ill_plain=float(e_plain[ill].max()) if ill.any()
               else 0.0)
    check(out["err"] < 5e-4, f"DLT S={s}: max abs err {out['err']}")
    check(out["err64"] < 1e-6, f"DLT S={s}: max abs err {out['err64']} vs "
          f"float64 on the usable quads")
    return hs, ok, out


def eig_parity(atas):
    """K3 (`smallest_eigvec_9x9_batch`) on (C, 9, 9) normal matrices: one
    launch, (C, 9) vectors. float32 fixes a smallest eigenvector only to
    the first-order floor eps32 * lam_max / (lam_2 - lam_1), up to ~2e-3
    on the F refits' matrices: each vector within twice that floor of
    float64 eigh, and where the floor is below 1e-5 within 1e-5 of the
    round-robin plain version (the kernel's order and rounding) and under
    1e-4 of the cyclic one (the JAX twin's order). Returns a dict: `well`
    the count of those, `err` / `err_cyclic` the kernel's max-abs error
    there, `err_all` / `err_all_cyclic` over all, `ratio` / `ratio_plain`
    the largest error / floor of the kernel and of the round-robin plain
    version."""
    from multih_tpu_torch.ops.kernels import eig_kernel as ek

    c = atas.shape[0]
    before = ek.smallest_eigvec_9x9_batch.launches
    got = ek.smallest_eigvec_9x9_batch(atas)
    check(ek.smallest_eigvec_9x9_batch.launches == before + 1,
          f"eig C={c}: not one launch")
    check(got.shape == (c, 9), f"eig C={c}: shape {tuple(got.shape)}")
    ev, vec = torch.linalg.eigh(atas.double().cpu())
    v64 = vec[..., 0]
    floor = torch.finfo(torch.float32).eps * ev[:, -1] / (ev[:, 1] - ev[:, 0])

    def err(v, to):
        v = v.double().cpu()
        sign = torch.sign((v * to).sum(1, keepdim=True))
        return (v * sign - to).abs().amax(1)

    rr = ek.smallest_eigvec_9x9_round_robin_reference(atas).double().cpu()
    cyc = ek.smallest_eigvec_9x9_batch_reference(atas).double().cpu()
    e64 = err(got, v64)
    out = dict(ratio=float((e64 / floor).max()),
               ratio_plain=float((err(rr, v64) / floor).max()))
    check(bool((e64 <= 2.0 * floor).all()), f"eig C={c}: "
          f"{out['ratio']:.3g} times the float32 floor from float64 eigh")
    well = floor < 1e-5
    e_rr, e_cyc = err(got, rr), err(got, cyc)
    out.update(well=int(well.sum()), err_all=float(e_rr.max()),
               err_all_cyclic=float(e_cyc.max()),
               err=float(e_rr[well].max()) if well.any() else 0.0,
               err_cyclic=float(e_cyc[well].max()) if well.any() else 0.0)
    check(out["err"] <= 1e-5 and out["err_cyclic"] < 1e-4,
          f"eig C={c} where the float32 floor is below 1e-5: max abs err "
          f"{out['err']} vs the round-robin plain version, "
          f"{out['err_cyclic']} vs the cyclic one")
    return out


def refit_errors(model, mom, got, ref, T1g, T2g):
    """(err_got, err_ref, fixed), each (C,) numpy: the sign-aligned
    max-abs distance of two float32 refits of the moments `mom` (the
    kernels' and the plain route's) from the float64 refit of the same
    moments (the plain assembly's smallest eigenvector by float64 eigh;
    for F its nearest rank-2 matrix), each taken back in float64 into the
    candidate's normalized frame, where its nullvector lives (in the raw
    frame the global similarities' pixel scales hide what differs); and
    the candidates whose nullvector float32 fixes: the float64 normal
    matrix has a finite eigenvector floor and the plain route lands
    within 1e-2 of it (no weight, or three members, fix none)."""
    from multih_tpu_torch.ops import fmodel, geometry

    mom64 = mom.double().cpu()
    if model == "homography":
        atas, params = geometry._moments_to_ata(mom64.reshape(-1, 5, 6))
    else:
        atas, params = fmodel._moments_to_ata_f(mom64.reshape(-1, 6, 6))
    s1 = geometry._similarity(*params[:3])
    s2 = geometry._similarity(*params[3:])
    t1, t2 = T1g.double().cpu(), T2g.double().cpu()

    def back(m):
        m = m.double().cpu()
        if model == "homography":
            x = s2 @ t2 @ m @ torch.linalg.inv(t1) @ torch.linalg.inv(s1)
        else:
            x = (torch.linalg.inv(s2 @ t2).transpose(1, 2) @ m
                 @ torch.linalg.inv(s1 @ t1))
        return x.reshape(-1, 9) / torch.linalg.matrix_norm(x)[:, None]

    ev, vec = torch.linalg.eigh(atas)
    v = vec[..., 0].reshape(-1, 3, 3)
    if model == "fundamental":
        u, sv, vh = torch.linalg.svd(v)
        v = u @ torch.diag_embed(sv * torch.tensor([1.0, 1.0, 0.0],
                                                   dtype=sv.dtype)) @ vh
    truth = v.reshape(-1, 9) / torch.linalg.matrix_norm(v)[:, None]

    def err(x):
        return (x * torch.sign((x * truth).sum(1, keepdim=True))
                - truth).abs().amax(1).numpy()

    e_got, e_ref = err(back(got)), err(back(ref))
    floor = (torch.finfo(torch.float32).eps * ev[:, -1]
             / (ev[:, 1] - ev[:, 0])).numpy()
    return e_got, e_ref, np.isfinite(floor) & (e_ref < 1e-2)


def refit_parity(model, mom, T1g, T2g, min_fixed=1):
    """The moment refit's kernels (`moment_refit_batch`: assembly, K3,
    denormalization) against the plain card route (the plain ops around
    K3) on the same (C, 30 / 36) moments: one refit call with one K3
    launch on the wrappers' counts; (C, 3, 3) models, finite and of unit
    Frobenius norm; at least `min_fixed` candidates whose nullvector
    float32 fixes, and on them as close to the float64 refit as the
    plain route (`refit_errors`: the largest error at most twice the
    plain route's + 1e-5, the median at most twice its median + 1e-6;
    the float32 assembly's rounding, not K3, sets both routes' error);
    F's largest |det| at most 10 times the plain route's. Returns a dict:
    `fixed`, `err` / `err_ref` and `med` / `med_ref` on the fixed
    candidates, `raw` the routes' largest raw-frame difference there,
    and for F `det` / `det_ref`."""
    from multih_tpu_torch.ops.kernels import eig_kernel as ek

    c = mom.shape[0]
    before = (ek.moment_refit_batch.launches,
              ek.smallest_eigvec_9x9_batch.launches)
    got = ek.moment_refit_batch(mom, model, T1g, T2g)
    check((ek.moment_refit_batch.launches,
           ek.smallest_eigvec_9x9_batch.launches)
          == (before[0] + 1, before[1] + 1), f"refit {model} C={c}: not "
          f"one refit call with one K3 launch")
    ref = ek.moment_refit_reference(mom, model, T1g, T2g)
    check(got.shape == (c, 3, 3) and bool(torch.isfinite(got).all())
          and float((torch.linalg.matrix_norm(got.double()) - 1.0)
                    .abs().max()) < 1e-5,
          f"refit {model} C={c}: a model not finite or not unit")
    e_got, e_ref, fixed = refit_errors(model, mom, got, ref, T1g, T2g)
    check(int(fixed.sum()) >= min_fixed, f"refit {model} C={c}: "
          f"{int(fixed.sum())} candidates with a fixed nullvector, fewer "
          f"than {min_fixed}")
    g, r = got.double().cpu(), ref.double().cpu()
    raw = (g * torch.sign((g * r).sum((1, 2), keepdim=True)) - r).abs()
    out = dict(fixed=int(fixed.sum()), err=float(e_got[fixed].max()),
               err_ref=float(e_ref[fixed].max()),
               med=float(np.median(e_got[fixed])),
               med_ref=float(np.median(e_ref[fixed])),
               raw=float(raw.amax((1, 2))[torch.from_numpy(fixed)].max()))
    check(out["err"] <= 2.0 * out["err_ref"] + 1e-5
          and out["med"] <= 2.0 * out["med_ref"] + 1e-6,
          f"refit {model} C={c}: farther from float64 than the plain "
          f"route: {out}")
    if model == "fundamental":
        fx = torch.from_numpy(fixed)
        out.update(det=float(torch.linalg.det(g)[fx].abs().max()),
                   det_ref=float(torch.linalg.det(r)[fx].abs().max()))
        check(out["det"] <= 10.0 * out["det_ref"], f"refit F C={c}: |det| "
              f"{out['det']:.3g}, plain {out['det_ref']:.3g}")
    return out


def accept_parity(fb_args, relabel_energy, residuals, got=None):
    """The F accept fallback's kernel route (`f_accept_fallback`: a
    front, K5 and a back a step) against the plain loop
    `pipeline._f_fallback_plain` on the same state (`fb_args` as the
    route is handed them): the same steps taken, each step's energy
    equal, the models bit for bit. `got` is the route's result on those
    arguments, or None to run it here (then 2 K end launches on the
    wrapper's count). Returns a dict: `k` steps, `ok` proposals ok,
    `taken` steps taken, `unchanged` those of an unchanged model."""
    from multih_tpu_torch.models import pipeline
    from multih_tpu_torch.ops.kernels import accept_kernel

    hs_c, r_c, lab_c, e_c, hs_prop, _, ok_prop = fb_args[:7]
    k = r_c.shape[0]
    if got is None:
        n0 = accept_kernel.f_accept_fallback.launches
        got = accept_kernel.f_accept_fallback(*fb_args)
        n = accept_kernel.f_accept_fallback.launches - n0
        check(n == 2 * k, f"accept fallback: {n} end launches, expected "
              f"{2 * k}")
    hs_k, e_k, took_k = got
    hs_p, e_p, took_p = pipeline._f_fallback_plain(
        hs_c, r_c, lab_c, e_c, hs_prop, ok_prop, relabel_energy, residuals)
    check(torch.equal(took_k, took_p), f"accept fallback: steps taken "
          f"{took_k.tolist()}, plain {took_p.tolist()}")
    off = (e_k != e_p).nonzero().flatten().tolist()
    check(not off, f"accept fallback: step energies differ "
          f"{[(i, float(e_k[i]), float(e_p[i])) for i in off]}")
    check(torch.equal(hs_k, hs_p), f"accept fallback: models differ from "
          f"the plain loop's by {float((hs_k - hs_p).abs().max()):.3g}")
    return dict(k=k, ok=int(ok_prop.sum()), taken=int(took_k.sum()),
                unchanged=int((took_k & ~ok_prop).sum()))


def band_list_parity(band, nbr=None):
    """The neighbour list (`band_list`) of a band bit for bit its plain
    version's, dtypes included, and `nbr` (a fit's list) equal to it.
    Returns the list."""
    from multih_tpu_torch.ops.kernels import mrf_kernel as mk

    got, ref = mk.band_list(band), mk.band_list_reference(band)
    check(all(a.dtype == b.dtype and torch.equal(a, b)
              for a, b in zip(got, ref)), "neighbour list: not exact")
    check(nbr is None or all(torch.equal(a, b) for a, b in zip(nbr, ref)),
          "the fit's neighbour list differs from the band's")
    return got


def mean_field_parity(q0, base, band, inv_t, sw, nbr):
    """K4 (`mean_field_fused`) with the list `nbr` against its plain
    version: one launch, q finite and within 1e-5 max-abs (the agreement
    sums in list order); without a list the wrapper builds one: the same
    q. Returns the max-abs error."""
    from multih_tpu_torch.ops.kernels import mrf_kernel as mk

    before = mk.mean_field_fused.launches
    got = mk.mean_field_fused(q0, base, band, inv_t, sw, nbr=nbr)
    check(mk.mean_field_fused.launches == before + 1,
          "mean-field: not one launch")
    err = float((got - mk.mean_field_fused_reference(
        q0, base, band, inv_t, sw)).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= 1e-5,
          f"mean-field N={q0.shape[1]}: max abs err {err}")
    check(torch.equal(mk.mean_field_fused(q0, base, band, inv_t, sw), got),
          "mean-field: the wrapper's own list gives another q")
    return err


def icm_parity(starts, base, band, iterations, sw, nbr=None, **kw):
    """K5 (`icm_fused`, `kw` its half-sweep options) against its plain
    version: one launch, the labels equal, some label moved. Returns the
    labels."""
    from multih_tpu_torch.ops.kernels import mrf_kernel as mk

    before = mk.icm_fused.launches
    got = mk.icm_fused(starts, base, band, iterations, sw, nbr=nbr, **kw)
    check(mk.icm_fused.launches == before + 1, "ICM: not one launch")
    ref = mk.icm_fused_reference(starts, base, band, iterations, sw, **kw)
    check(torch.equal(got, ref), f"ICM N={starts.shape[1]}: "
          f"{int((got != ref).sum())} labels differ")
    check(bool((got != starts).any()), "ICM moved no label")
    return got


def front_parity(q0, x1, x2, valid, adj, hs, active, inv_t, thr, sw, kind):
    """K6 (`mean_field_fused_front`) on the fit's own tensors (the band
    `adj` with its list) against its plain version, thr a device tensor:
    one launch, and the wrapper's own list gives the same result; r to
    rtol 1e-3 / atol 1e-4 up to 1e6 px^2 and min(r/thr, 8) to atol 1e-4
    everywhere; dct equal to data_costs_t of the kernel's own r (rtol
    2e-6); q equal to K4's on the kernel's own base dct + sw*deg bit for
    bit (the same sweep code), so within 1e-5 of the plain sweeps there,
    and within 1e-4 of the plain version end to end (q0 itself with no
    sweep). From the float64 residuals of the same float32 inputs, r
    (relative, up to 1e6 px^2) and min(r/thr, 8) each within 8x the
    plain version's own distance (the kernel rounds each term where the
    plain matmul fuses; over tools/torch_float_floor.py's 8 draws at the
    stress shape it reached 3.4x and 5.0x).
    Past 1e6 px^2 (a transfer 1000 px off) w nears zero, and its float32
    cancellation, not the kernel, sets r's digits: the elementwise sum
    and the plain version's matmul differ by up to 15% at r ~ 1e14
    (measured on the card); the cost is saturated there on both sides.
    Below it, px - u cancels: r ~ 10 px^2 moves by ~1e-4 px^2 between the
    two roundings, dct by ~1e-5, and one sweep at 1/T = 4 turns that into
    ~1.1e-5 of q (measured). Returns a dict: `err` q's max-abs error, `rel`
    r's largest relative error up to 1e6 px^2, `far` the residuals past
    it, `d_r` / `d_c` the kernel's and the plain version's distances from
    float64."""
    from multih_tpu_torch.models import labeling
    from multih_tpu_torch.ops import geometry
    from multih_tpu_torch.ops.kernels import mrf_kernel as mk

    args = (q0, x1, x2, valid, adj.deg, hs, active, adj.band, inv_t, thr, sw,
            1.0, kind)
    before = mk.mean_field_fused_front.launches
    q, dct, r = mk.mean_field_fused_front(*args, nbr=adj.nbr)
    check(mk.mean_field_fused_front.launches == before + 1,
          "fused front: not one launch")
    own = mk.mean_field_fused_front(*args)
    check(all(torch.equal(a, b) for a, b in zip(own, (q, dct, r))),
          "fused front: the wrapper's own list gives another result")
    q_ref, _, r_ref = mk.mean_field_fused_front_reference(*args)
    near = r_ref <= 1e6
    torch.testing.assert_close(r[near], r_ref[near], rtol=1e-3, atol=1e-4,
                               msg=lambda m: f"fused front r: {m}")
    check(bool((r[~near] > 8.0 * thr).all()),
          f"fused front {kind}: an unsaturated far residual")
    torch.testing.assert_close(torch.clamp_max(r / thr, 8.0),
                               torch.clamp_max(r_ref / thr, 8.0),
                               rtol=0, atol=1e-4,
                               msg=lambda m: f"fused front min(r/thr, 8): {m}")
    torch.testing.assert_close(
        dct, labeling.data_costs_t(r, valid, thr, 1.0, active),
        rtol=2e-6, atol=1e-6, msg=lambda m: f"fused front dct: {m}")
    t = float(thr)
    r64 = geometry.residual_matrix(hs.double(), x1.double(), x2.double(),
                                   kind)
    near64 = r64 <= 1e6
    d_r = [float(((a.double() - r64).abs()
                  / r64.abs().clamp_min(1e-4))[near64].max())
           for a in (r, r_ref)]
    d_c = [float((torch.clamp_max(a.double() / t, 8.0)
                  - torch.clamp_max(r64 / t, 8.0)).abs().max())
           for a in (r, r_ref)]
    check(d_r[0] <= 8.0 * d_r[1] and d_c[0] <= 8.0 * d_c[1],
          f"fused front {kind}: from float64, r (relative) {d_r[0]:.3g} "
          f"against the plain version's {d_r[1]:.3g}, min(r/thr, 8) "
          f"{d_c[0]:.3g} against {d_c[1]:.3g}")
    base = (dct + sw * adj.deg.T).contiguous()
    if inv_t.shape[0]:
        check(torch.equal(q, mk.mean_field_fused(q0, base, adj.band, inv_t,
                                                 sw, nbr=adj.nbr)),
              f"fused front {kind}: q differs from K4's on its own base")
    else:
        check(torch.equal(q, q0), "fused front: q moved without a sweep")
    q_own = mk.mean_field_fused_reference(q0, base, adj.band, inv_t, sw)
    err = float((q - q_ref).abs().max())
    check(bool(torch.isfinite(q).all())
          and float((q - q_own).abs().max()) <= 1e-5 and err <= 1e-4,
          f"fused front {kind}: q max abs err {err} (plain version), "
          f"{float((q - q_own).abs().max())} (plain sweeps on its base)")
    rel = (r - r_ref).abs() / r_ref.abs().clamp_min(1e-4)
    return dict(err=err, rel=float(rel[near].max()), far=int((~near).sum()),
                d_r=d_r, d_c=d_c)


def gather_parity(win, sel, mode):
    """K7 (`window_gather`) bit for bit its plain version's. Returns the
    plain result."""
    from multih_tpu_torch.ops.kernels import gather_kernel as gk

    ref = gk.window_gather_reference(win, sel, mode)
    check(torch.equal(gk.window_gather(win, sel, mode), ref),
          f"window gather {mode}: not exact")
    return ref
