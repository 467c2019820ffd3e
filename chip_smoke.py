#!/usr/bin/env python3
"""Check the PyTorch + CUDA port of the Multi-H fit on one GPU: the
homography fit (default and fused-front routes), the fundamental
(multi-motion) fit, the adaptive-threshold fit, the frame stream, the
mixed plane + motion fit, the batch surface, the affine one-point pool,
the direct refit, the CLI, the mesh axes ('pair', 'hyp', 'pt'), the
dryrun of every mesh path and the fits captured as CUDA graphs.

Run from the repository root on a host with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Each kernel is held to its plain version by tests/card_checks.py's
checks, which the `cuda`-marked tests share (python -m pytest
tests/test_torch_kernels.py tests/test_torch_accept.py
tests/test_torch_motion.py --noconftest; tests/test_torch_mixed.py
--noconftest -m cuda); the golden contracts are those tests'. A
kernel's time is tools/torch_kernel_ab.py's, a captured fit's the
benchmark's (python3 -m portbench.run). A run reports pass or fail, the
largest errors it holds and each path's kernel launches (each wrapper's
count, set to 0 just before the path and read just after).

Phases, each raising on failure:
  1. environment: torch / CUDA / nvcc / triton / cv2, the card's name
     and power limit, TF32 off;
  2. build: nvcc compiles multih_tpu_torch/csrc/*.cu, one process per
     source (the ptxas register / spill report);
  3. each kernel against its plain version at the main paths' shapes:
     K1 at the claim / verify, stress ranking and split-point sweeps,
     the epipolar kinds on fm4_a, the mixed stage shape and the affine
     fit's own pool, in both reciprocal modes; K2 on sampler rows at
     S=512 and 51200; K3 on homography normal matrices (C=256, 16), a
     motion fit's first F refit and the mixed polish's last; the refit's
     kernels on real fits' moments (H first 256 / 16; F first 256 / 16,
     last 256); the accept fallback on a motion fit's first and last
     accept (3 K device ops a call); the neighbour list, K4 and K5 at
     the default, stress and mixed shapes; K6 at the default and stress
     shapes in both homography kinds; K7 at the stress shapes. Each
     call's device ops are counted (torch.profiler; a captured graph's
     nodes for the accept);
  4. the side config MultiHConfig(knn_window=False, knn_approx=False)
     and the default config on BASELINE config 2 (exact recovery; K1-K3
     and the refit's kernels, and K4, K5 and the list build at the
     default config); the fused-front route (mrf_fused_front=True) on
     BASELINE config 2 and three golden scenes (>= 97% agreement with
     the golden labels; K6 once a PEARL iteration, no K4); on easy2_a
     the card fit against the CPU fit and the fused-front fit on the
     same draws (>= 97% label agreement);
  5. the stress fit at bench.py::_stress_cfg(10240, 102400,
     n_candidates=256, max_labels=16)'s settings (window sampling, the
     windowed graph; 10k points, 70% outliers, 8 planes: 8 planes, no
     far edge dropped), with every homography kernel but K6 launched;
     the same scene on the fused-front route (K6 in place of K4) and at
     the side config (the row-blocked exact graph past N=4096, a band
     with far edges; K1-K3, the refit's kernels);
  6. the fundamental-model fit at the motion suite's config on fm2_b and
     fm4_a (key 0, the golden tau): the launches of each fit (K1 at
     f_sampson, K3, the refit's kernels, K4, K5, the list, the accept's
     ends: 2 K an accept; no K2, no K7);
  7. one two-pass adaptive-threshold fit (fit_adaptive) on a noise-1 px
     scene: tau in (4.5, 7.5) on the card, 3 planes, error < 3%;
  8. run_stream on the CLI's `stream synth` defaults, warm-started and
     cold, at pipeline depths 1 and 3, and preloaded: 30 frames, >= 2.5
     planes a frame on average;
  9. the mixed plane + motion fit at the mixed goldens' configs: one fit
     each of mx21_a and mx22_b at N=1024 (K1 at both kinds, K2, K3, the
     refit's kernels of both models, K4, K5, the list and the accept's
     ends, 2 Kf an accept; no K6, no K7); one fit and one
     fit_mixed_adaptive at N=640, where both stages take the gather-path
     labeling (no K4, K5, list build or accept end), against their
     scenes' classes and taus;
 10. run_benchmark_batch on the 24 homography golden scenes at N=1024
     with the golden taus (each pair >= 97% in agreement with its golden
     labels and equal to its single fit on the card); the affine
     one-point fit (2 planes, error < 3%; its one-point pool on the card
     against the CPU's on one F); the direct-refit fit
     (refit_moments=False) on BASELINE config 2 (exact recovery; no K3,
     no refit kernels); `python -m multih_tpu_torch.cli synth --json`
     as a subprocess;
 11. the mesh axes: two gloo ranks share the one card (NCCL refuses two
     ranks on one device). On a (1, 2) mesh: hyp_sharded_fit of the
     stress scene and of the motion config on fm4_a, each equal to the
     single card fit (labels, active and n_hypotheses_ok exact, H's
     within rtol 2e-4 / atol 2e-5, 8/8 planes), the sharded pick's
     candidates, and sharded_verification of the stress pool equal to
     the unsharded stable top-M; on a (2, 1) mesh, run_benchmark_batch
     of the 24 scenes equal to phase 10's batch; each rank's launches;
     then sharded_verification on a one-rank NCCL mesh (nothing staged
     through the host);
 12. the 'pt' (point) axis: two gloo ranks share the card on a (pt=2)
     mesh, each owning half of the Morton blocks. On BASELINE config 2
     (N=1024), the stress cell (N=10240), the F model on fm4_a (N=512,
     held to the motion bound |delta| <= 2.0 pp) and at full width
     (N=10240, agree_block 128), and BASELINE config 2 on the exact
     graph (its far edges' columns gathered once a sweep, no K4 or K5)
     and on an exact graph with no far edge (N=512: the rank's list built
     once, K4 and K5 a launch a sweep): the rank's k-NN rows, labels,
     active and n_far_dropped equal to the single card fit's, the energy
     within rtol 1e-3, each rank's launches equal to the single fit's
     (K4 and K5 times their sweeps a call: a launch a sweep); then K4
     and K5 on each rank's window at
     the stress shape, its own blocks bit-equal to the unsharded launch;
 13. tools/torch_dryrun_multichip.py on two gloo ranks sharing the card:
     every mesh path at the reference's tiny shapes, asserted on known
     labels in the ranks, each rank's launches counted;
 14. the fits' kinds captured as CUDA graphs (utils/aot.py): the
     homography fit's (cached_fit) on easy2_a (N=512), BASELINE config 2
     (N=1024, exact from the replay), the fused-front route, the stress
     cell, fit_tau, fit_seeded and fit_adaptive; the motion fit's fit,
     fit_tau and fit_adaptive on fm4_a; the mixed fit's
     (cached_fit_mixed) fit, fit_tau and fit_adaptive on mx21_a at
     N=1024 and its fit at N=640 (the gather path). On each: no
     synchronizing call in the eager fit (sync debug mode), eager equal
     to eager, the first call (warm-up, capture, replay) and a second
     seed's replay equal to their eager twins bit for bit with the
     generator left in the same state (where eager does not equal
     eager, the replays held to the mixed goldens' contract instead),
     the launches a replay by kernel equal to an eager fit's, and on
     five cells the profiler's kernels of a replay equal to the
     capture's. Then `cli synth --json --aot` in a fresh process on an
     empty and on a filled cache root, equal to the run without --aot,
     `synth --model fundamental` and `--model mixed` with and without
     --aot (the same JSON but the timings), and a truncated library
     under a temporary cache root rebuilt once.
Then one JSON line of each kernel's largest error, its launches by path
and the phases' results, the card line, and the last line {"ok": true, "device": {...}}. Without a
CUDA device, or outside the repository, it exits nonzero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import card_checks as cc  # noqa: E402  (the checks the card tests share)
from card_checks import (affine_fit, card_line, check,  # noqa: E402
                         count_launches, cpu_draws, golden_batch, hv_inputs,
                         mixed_cfgs, motion_cfg, motion_points, sh,
                         stress_cfg, stress_points, suite_points, to)

GOLDEN_SCENES = (("easy2_a", 512), ("med3_a", 512), ("hard5_a", 1024))
MOTION_SCENES = ("fm2_b", "fm4_a")
MIXED_SCENES = ("mx21_a", "mx22_b")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env():
    import torch

    print("== 1. environment")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"torch.version.cuda {torch.version.cuda}")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    print("nvcc:", sh([nvcc, "--version"]).splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__} imports")
    except ImportError as e:
        print(f"triton does not import: {e}")
    try:
        import cv2
        print(f"cv2 {cv2.__version__} imports (fit-images can run)")
    except ImportError as e:
        print(f"cv2 does not import: {e}")
    print("card:", card_line())
    print(f"device count {torch.cuda.device_count()}, "
          f"name {torch.cuda.get_device_name(0)}, "
          f"capability {torch.cuda.get_device_capability(0)}")
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    check(not torch.backends.cudnn.allow_tf32, "TF32 cudnn is on")


def phase_build():
    from multih_tpu_torch.ops.kernels import _build

    print("== 2. build")
    _build.load()
    _, log, path = _build.build_report()
    print(f"library {os.path.relpath(path, ROOT)}")
    for line in log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            print("  ptxas:", line.strip().removeprefix("ptxas info    : "))


def phase_kernels(dev):
    """Phase 3: each kernel at the main paths' shapes against its plain
    version (tests/card_checks.py's `*_parity`, which the card tests
    share), with its device ops a call. Returns {kernel: {max_abs_err,
    shapes: [{shape, max_abs_err, launches_per_call}]}}."""
    import torch

    from multih_tpu_torch.ops import fmodel, geometry, sampling
    from multih_tpu_torch.ops.kernels import _build, accept_kernel
    from multih_tpu_torch.ops.kernels import dlt_kernel, eig_kernel
    from multih_tpu_torch.ops.kernels import gather_kernel as gk
    from multih_tpu_torch.ops.kernels import mrf_kernel as mk
    from multih_tpu_torch.ops.kernels import residual_kernel as rk
    from multih_tpu_torch.utils import data

    print("== 3. the kernels against their plain versions")
    rng = np.random.default_rng(0)
    rows = {}
    x = torch.zeros(1, device=dev)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        check(_build.stream_handle(x) == side.cuda_stream,
              "stream handle: not the side stream's")
    check(_build.stream_handle(x) == torch.cuda.current_stream().cuda_stream,
          "stream handle: not the current stream's")

    def row(name, shape, err, fn, expect=1, note=""):
        """One kernel call's row: its device ops a call (the profiler's,
        None where it lost events in every session) must be `expect`."""
        n, names = cc.cuda_launches(fn)
        check(n in (expect, None), f"{name} {shape}: launches {names}, "
              f"expected {expect}")
        r = rows.setdefault(name, dict(max_abs_err=0.0, shapes=[]))
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        r["shapes"].append(dict(shape=shape, max_abs_err=float(err),
                                launches_per_call=n))
        print(f"{name:22s} {shape:38s} max_abs_err {err:<10.4g} launches a "
              f"call {'lost' if n is None else n}{note}")

    def counts(Hs, x1, x2, valid, thr, kind):
        name = "inlier_counts_f" if kind.startswith("f_") else "inlier_counts"
        for approx in (True, False):
            _, err = cc.count_parity(Hs, x1, x2, valid, thr, kind,
                                     approx_rcp=approx)
            row(name, f"{Hs.shape[0]}x{x1.shape[0]} {kind} "
                f"{'approx' if approx else 'exact'}", err,
                lambda: rk.inlier_counts_padded(Hs, x1, x2, valid, thr,
                                                kind=kind, approx_rcp=approx))

    # K1: the claim / verify sweep, the stress ranking sweep, a point axis
    # past one tile (a cluster of 5 CTAs) and split over 8 warps x 8 CTAs
    x1, x2, valid = cc.scene_points(10000, 10240, 42, dev)
    thr = torch.full((), 9.0, device=dev)
    for s, n, kind in ((2051, 512, "symmetric"), (2051, 512, "sampson"),
                       (102400, 1280, "transfer"),
                       (2051, 10240, "symmetric"), (16, 10240, "symmetric")):
        idx = torch.from_numpy(rng.integers(0, 10000, (s, 4))).to(dev)
        Hs = geometry.homography_4pt_batch_qr(x1[idx], x2[idx]).contiguous()
        counts(Hs, x1[:n], x2[:n], valid[:n], thr, kind)
    # K1's epipolar kinds at the motion verify shape (fm4_a), the mixed
    # fit's stage shape (mx21_a, N=1024) and the affine fit's own pool
    x1, x2, valid = motion_points("fm4_a", 512, dev)
    for kind in ("f_sampson", "f_symmetric", "f_transfer"):
        idx = torch.from_numpy(rng.integers(0, int(valid.sum()),
                                            (2051, 8))).to(dev)
        Fs = fmodel.fundamental_8pt_batch_qr(x1[idx], x2[idx]).contiguous()
        counts(Fs, x1, x2, valid, thr, kind)
    x1, x2, valid = suite_points(data.mixed_suite_scene("mx21_a"), 1024, dev)
    idx = torch.from_numpy(rng.integers(0, int(valid.sum()),
                                        (2051, 8))).to(dev)
    counts(geometry.homography_4pt_batch_qr(x1[idx[:, :4]], x2[idx[:, :4]])
           .contiguous(), x1, x2, valid, thr, "symmetric")
    counts(fmodel.fundamental_8pt_batch_qr(x1[idx], x2[idx]).contiguous(),
           x1, x2, valid, thr, "f_sampson")
    hs, x1, x2, valid, kind, thr = cc.affine_verify_pool(dev)
    counts(hs, x1, x2, valid, thr, kind)

    # K2: a progressive round's minimal solves, default and stress
    for s in (512, 51200):
        gt = cc.sampler_rows(rng, s, dev)
        _, _, d = cc.dlt_parity(gt)
        row("dlt_4pt", f"S={s} (32, S) rows", d["err"],
            lambda: dlt_kernel.homography_4pt_gt(gt),
            note=f"; {d['usable']} usable quads, max abs err vs float64 "
            f"{d['err64']:.3g}; {d['ill']} ill-conditioned")

    # K3: the LO refine and a PEARL refit, a motion fit's first F refit
    # and the mixed polish's last
    sets = [(f"C={c}", cc.normal_matrices(rng, c).to(dev).contiguous())
            for c in (256, 16)]
    sets.append(("C=256 F (fm4_a fit)", cc.f_normal_matrices_of(
        cc.fit_refit_batch("fundamental", 256, False, dev)[0])))
    sets.append(("C=8 F (mixed polish)", cc.f_normal_matrices_of(
        cc.fit_refit_batch("mixed", 8, True, dev)[0])))
    for shape, atas in sets:
        h = cc.eig_parity(atas)
        if "F" not in shape:
            check(h["err_all_cyclic"] < 1e-4, f"eig {shape}: max abs err "
                  f"{h['err_all_cyclic']} vs the cyclic version")
        row("eig9_smallest", shape, h["err"],
            lambda: eig_kernel.smallest_eigvec_9x9_batch(atas),
            note=f"; {h['well']} of {atas.shape[0]} with a floor below "
            f"1e-5; error / floor vs float64: kernel {h['ratio']:.3g}, "
            f"plain {h['ratio_plain']:.3g}")

    # the moment refit's kernels on real fits' moments: 3 launches a call
    for fit, model, c, last in (("homography", "homography", 256, False),
                                ("homography", "homography", 16, False),
                                ("fundamental", "fundamental", 256, False),
                                ("fundamental", "fundamental", 16, False),
                                ("fundamental", "fundamental", 256, True)):
        mom, T1g, T2g = cc.fit_refit_batch(fit, c, last, dev)
        p = cc.refit_parity(model, mom, T1g, T2g)
        row("moment_refit" + ("_f" if model == "fundamental" else ""),
            f"{'last' if last else 'first'} C={c}", p["err"],
            lambda: eig_kernel.moment_refit_batch(mom, model, T1g, T2g), 3,
            note=f"; {p['fixed']} fixed, from float64 max / median: "
            f"{p['err']:.3g} / {p['med']:.3g}, plain {p['err_ref']:.3g} / "
            f"{p['med_ref']:.3g}")

    # the F accept fallback on the first and last accept of a motion fit
    # (fm4_a): the ends a step on the wrapper's count, 3 K device ops a
    # call (a front, K5 and a back a step) in a captured graph
    states = cc.accept_states(dev)
    cfg = motion_cfg(512)
    check(len(states) == _accept_ends(cfg) // (2 * cfg.max_labels),
          f"accept fallback: {len(states)} accepts")
    for which, (args, relabel_energy, residuals) in (("first", states[0]),
                                                     ("last", states[-1])):
        a = cc.accept_parity(args, relabel_energy, residuals)
        n = cc.graph_ops(lambda: accept_kernel.f_accept_fallback(*args))
        check(n == 3 * a["k"], f"accept fallback {which}: {n} device ops")
        rows.setdefault("f_accept_step", dict(max_abs_err=0.0, shapes=[]))[
            "shapes"].append(dict(shape=f"{which} accept K={a['k']}",
                                  max_abs_err=0.0, launches_per_call=n))
        print(f"f_accept_step          {which} accept K={a['k']}: "
              f"{a['ok']} proposals ok, {a['taken']} steps taken "
              f"({a['unchanged']} of an unchanged model), equal to the "
              f"plain loop; device ops a call {n}")

    # the list, K4 and K5 at the default, stress and mixed stage shapes
    # and the default config at N=1024 (its own generator)
    sw = 0.1
    for l, n_points, n, block, sweeps, icm_it, g in (
            (17, 500, 512, 256, 6, 2, rng),
            (17, 10000, 10240, 128, 4, 1, rng),
            (9, 1000, 1024, 256, 6, 2, rng),
            (17, 1000, 1024, 256, 6, 2, np.random.default_rng(1))):
        _, _, valid, _, adj = cc.windowed_problem(dev, n_points, n, block)
        dct = torch.from_numpy(g.uniform(0, 2.0, (l, n)).astype(
            np.float32)).to(dev) * valid[None, :]
        q0 = torch.softmax(-dct / 2.0, dim=0).contiguous()
        base = (dct + sw * adj.deg.T).contiguous()
        band, nbr = adj.band, adj.nbr
        inv_t = torch.from_numpy((1.0 / np.geomspace(2.0, 0.25, sweeps))
                                 .astype(np.float32)).to(dev)
        shape = f"L={l} N={n} B={block}"
        cc.band_list_parity(band, nbr)
        row("band_list", f"N={n} B={block}", 0.0, lambda: mk.band_list(band),
            note=f"; {int(nbr.cnt.sum())} pairs, at most "
            f"{int(nbr.cnt.max())} a row")
        err = cc.mean_field_parity(q0, base, band, inv_t, sw, nbr)
        row("mean_field_fused", f"{shape} sweeps={sweeps}", err,
            lambda: mk.mean_field_fused(q0, base, band, inv_t, sw, nbr=nbr))
        starts = torch.stack([
            torch.argmin(dct, dim=0),
            torch.from_numpy(g.integers(0, l, n)).to(dev),
        ]).to(torch.int32).contiguous()
        cc.icm_parity(starts, base, band, icm_it, sw, nbr)
        row("icm_fused", f"{shape} S=2 iterations={icm_it}", 0.0,
            lambda: mk.icm_fused(starts, base, band, icm_it, sw, nbr=nbr))

    # K6 at the default and stress shapes, both homography kinds: 15
    # near-identity planes, one inactive, and a wild one
    l, k = 17, 16
    for n_points, n, block, sweeps in ((500, 512, 256, 6),
                                       (10000, 10240, 128, 4)):
        x1, x2, valid, _, adj = cc.windowed_problem(dev, n_points, n, block)
        hs = np.eye(3)[None] + rng.normal(0, 0.02, (k, 3, 3))
        hs[:, 0, 2] += rng.normal(0, 5.0, k)  # pixel shifts
        hs[-1] = rng.normal(0, 1.0, (3, 3))
        hs = torch.from_numpy(hs.astype(np.float32)).to(dev)
        active = torch.ones(k, device=dev)
        active[1] = 0.0
        q0 = torch.softmax(torch.from_numpy(rng.normal(size=(l, n)).astype(
            np.float32)).to(dev), 0)
        thr = torch.tensor(9.0, device=dev)
        inv_t = torch.from_numpy((1.0 / np.geomspace(2.0, 0.25, sweeps))
                                 .astype(np.float32)).to(dev)
        for kind in ("symmetric", "transfer"):
            f = cc.front_parity(q0, x1, x2, valid, adj, hs, active, inv_t,
                                thr, sw, kind)
            row("mean_field_fused_front", f"L={l} N={n} B={block} "
                f"sweeps={sweeps} {kind}", f["err"],
                lambda: mk.mean_field_fused_front(
                    q0, x1, x2, valid, adj.deg, hs, active, adj.band, inv_t,
                    thr, sw, 1.0, kind, nbr=adj.nbr),
                note=f"; r max rel err {f['rel']:.3g} up to 1e6 px^2, "
                f"{f['far']} past it; from float64 r {f['d_r'][0]:.3g} "
                f"(plain {f['d_r'][1]:.3g}), min(r/thr, 8) "
                f"{f['d_c'][0]:.3g} (plain {f['d_c'][1]:.3g})")

    # K7 at the stress shapes windowed_quadruples gives it, picks past
    # the range and ranks past each window's count included
    x1, x2, valid, nbr_idx, _ = cc.windowed_problem(dev, 10000, 10240, 128)
    avail = valid.clone()
    avail[:3000] = 0.0  # a claimed region: exhausted windows
    win_all = sampling.window_source(x1, x2, avail, nbr_idx, 128)
    nb, n_rows, _ = win_all.shape
    m_max = int(win_all[:, -1, gk.CUM_CH].max())
    for mode, t, hi in (("index", 1280, n_rows + 2),
                        ("rank", 1600, m_max + 8)):
        win = (win_all[:, :, :8] if mode == "index" else win_all).contiguous()
        sel = torch.from_numpy(rng.integers(-2, hi, (nb, t)).astype(
            np.int32)).to(dev)
        cc.gather_parity(win, sel, mode)
        row("window_gather", f"{mode} nb={nb} 3B={n_rows} C={win.shape[2]} "
            f"T={t}", 0.0, lambda: gk.window_gather(win, sel, mode))
    torch.cuda.synchronize()
    return rows


def _slice_cfg(**kw):
    """The side config the port ran first (exact k-NN, the general band
    with far edges, plain MRF sweeps)."""
    from multih_tpu_torch import MultiHConfig

    return MultiHConfig(knn_window=False, knn_approx=False, **kw)


def _accept_ends(cfg) -> int:
    """The accept fallback's end launches in one F fit at cfg on the
    kernel route: a front and a back for each of the max_labels models,
    at each accept of `pipeline._f_refine_phases`."""
    accepts = (cfg.f_exclusive_iterations * cfg.f_exclusive_refine
               + cfg.f_resample_iterations * cfg.f_resample_lo)
    return 2 * cfg.max_labels * accepts


def _baseline2(dev, cfg, gen):
    """BASELINE.json config 2: 1k noise-free correspondences, 2 planes,
    exact recovery."""
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import data, evaluation

    cs, _ = data.synthetic_scene(1000, 2, 0.0, 0.0)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 1024)
    res = mt.make_fit(cfg)(*to(dev, x1, x2, valid), gen.manual_seed(0))
    check(res.labels.device.type == res.homographies.device.type
          == torch.device(dev).type, "results not on the card")
    err = evaluation.misclassification_error(res.labels.cpu().numpy(), gt,
                                             cfg.max_labels)
    return int(res.active.sum()), err


def phase_fits(dev):
    """Phase 4: the side config and the default config on BASELINE
    config 2, the fused-front route on it and three golden scenes (the
    default config's golden contract is tests/test_torch_kernels.py's),
    and the card fit on easy2_a against the CPU fit and the fused-front
    fit on the same draws."""
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch import MultiHConfig
    from multih_tpu_torch.utils import data, evaluation

    print("== 4. the fit on the card: side, default and fused-front "
          "configs")
    gen = torch.Generator(device=dev)
    k123 = ("inlier_counts", "dlt_4pt", "eig9_smallest", "moment_refit")
    launches = {}

    def baseline2(label, cfg):
        planes, err = _baseline2(dev, cfg, gen)
        print(f"{label}, BASELINE config 2: planes {planes}, "
              f"misclassification {err:.4f}%")
        check(err == 0.0 and planes == 2,
              f"{label}: BASELINE config 2 not recovered exactly")

    _, launches["side"] = count_launches(
        "side-config", k123,
        lambda: baseline2("side config", _slice_cfg(max_points=1024)))
    _, launches["default"] = count_launches(
        "default-config", k123 + ("mean_field_fused", "icm_fused",
                                  "band_list"),
        lambda: baseline2("default config", MultiHConfig(max_points=1024)))

    def fused_goldens():
        """BASELINE config 2 and the golden scenes on the fused-front
        route: K6 takes the place of the residuals, data costs and K4 in
        every PEARL iteration."""
        baseline2("fused front", MultiHConfig(max_points=1024,
                                              mrf_fused_front=True))
        fits = {}
        for name, npad in GOLDEN_SCENES:
            g = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npz"))
            cs = data.suite_scene(name)
            cfg = MultiHConfig(max_points=npad, mrf_fused_front=True)
            x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels,
                                              npad)
            args = to(dev, x1, x2, valid)
            tau = float(g["inlier_threshold"])
            res = mt.make_fit_tau(cfg)(*args, gen.manual_seed(0), tau)
            lab = res.labels.cpu().numpy()[: cs.n_points]
            check(bool(torch.isfinite(res.homographies).all()),
                  "non-finite H")
            agree = 100.0 - evaluation.misclassification_error(
                lab, g["labels"], cfg.max_labels,
                gt_outlier=int(g["outlier_label"]))
            print(f"fused front, golden {name} (npad {npad}, tau {tau}): "
                  f"planes {int(res.active.sum())} (golden "
                  f"{int(g['n_planes'])}), agreement with the golden "
                  f"labels {agree:.2f}%")
            check(agree >= 97.0, f"fused front {name}: agreement "
                  f"{agree:.2f}% < 97%")
            fits[name] = (cfg, args, tau)
        return fits

    fused_fits, launches["fused_front"] = count_launches(
        "fused-front", k123 + ("mean_field_fused_front", "icm_fused",
                               "band_list"), fused_goldens)
    n_k6 = (1 + len(GOLDEN_SCENES)) * MultiHConfig().pearl_iterations
    check(launches["fused_front"]["mean_field_fused_front"] == n_k6,
          f"fused front: K6 launched "
          f"{launches['fused_front']['mean_field_fused_front']} times, not "
          f"pearl_iterations per fit ({n_k6})")
    check(launches["fused_front"]["mean_field_fused"] == 0,
          "fused front: K4 launched")

    # the card fit against the port's CPU fit on the same samples (the
    # CPU runs the plain paths: eigh instead of the Jacobi kernel, the
    # plain sweeps' arithmetic instead of the fused kernels'), and the
    # fused-front card fit against both
    cfg_fused, args, tau = fused_fits["easy2_a"]
    cfg = dataclasses.replace(cfg_fused, mrf_fused_front=False)
    f = mt.make_fit_tau(cfg)
    lab_gpu = f(*args, cpu_draws(1), tau).labels.cpu().numpy()
    lab_cpu = f(*[a.cpu() for a in args], cpu_draws(1), tau).labels.numpy()
    lab_fused = mt.make_fit_tau(cfg_fused)(
        *args, cpu_draws(1), tau).labels.cpu().numpy()
    for what, a, b in (("card fit vs CPU fit, default config", lab_gpu,
                        lab_cpu),
                       ("fused-front card fit vs default card fit", lab_fused,
                        lab_gpu),
                       ("fused-front card fit vs CPU fit", lab_fused,
                        lab_cpu)):
        agree = 100.0 - evaluation.misclassification_error(
            a, b, cfg.max_labels, gt_outlier=cfg.max_labels)
        print(f"easy2_a {what}, same draws: label agreement {agree:.2f}%")
        check(agree >= 97.0, f"easy2_a {what}: agreement {agree:.2f}%")
    return launches


def phase_stress(dev):
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import data, evaluation

    print("== 5. the stress fit (bench.py _stress_cfg's settings)")
    cfg = stress_cfg()
    cs, _ = data.synthetic_scene(10000, 8, 0.7, 0.5, seed=42)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 10240)
    args = to(dev, x1, x2, valid)
    f = mt.make_fit(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    # every homography kernel but K6
    k_stress = ("inlier_counts", "dlt_4pt", "eig9_smallest", "moment_refit",
                "band_list", "icm_fused", "window_gather")
    res, launches = count_launches(
        "stress", k_stress + ("mean_field_fused",), lambda: f(*args, gen))
    check(bool(torch.isfinite(res.homographies).all()), "non-finite H")
    lab = res.labels.cpu().numpy()
    check(lab.min() >= 0 and lab.max() <= cfg.max_labels, "labels range")
    err = evaluation.misclassification_error(lab, gt, cfg.max_labels)
    out = dict(planes=int(res.active.sum()), misclassification=err,
               n_far_dropped=int(res.n_far_dropped))
    print(f"stress: planes {out['planes']} of 8, misclassification "
          f"{err:.3f}%, n_far_dropped {out['n_far_dropped']}")
    check(out["planes"] == 8, f"stress: {out['planes']} planes of 8")
    check(out["n_far_dropped"] == 0, "stress: far edges dropped")

    # the same scene on the fused-front route: K6 once per PEARL
    # iteration in place of K4, every other kernel as before
    f_fused = mt.make_fit(dataclasses.replace(cfg, mrf_fused_front=True))
    res, fused_launches = count_launches(
        "fused-front stress", k_stress + ("mean_field_fused_front",),
        lambda: f_fused(*args, gen))
    check(fused_launches["mean_field_fused_front"] == cfg.pearl_iterations
          and fused_launches["mean_field_fused"] == 0,
          f"fused-front stress launches: {fused_launches}")
    check(bool(torch.isfinite(res.homographies).all()), "non-finite H")
    err = evaluation.misclassification_error(res.labels.cpu().numpy(), gt,
                                             cfg.max_labels)
    out["fused_front"] = dict(planes=int(res.active.sum()),
                              misclassification=err)
    print(f"fused-front stress: planes {out['fused_front']['planes']} of 8, "
          f"misclassification {err:.3f}%")
    check(out["fused_front"]["planes"] == 8,
          f"fused-front stress: {out['fused_front']['planes']} planes of 8")

    # the same scene at the side config: the exact graph's row blocks
    # (N > 4096) and the band's far-edge list run only at this size
    side = dataclasses.replace(cfg, knn_window=False, knn_approx=False,
                               window_sampling=False)
    res, side_launches = count_launches(
        "side-config stress", ("inlier_counts", "dlt_4pt", "eig9_smallest",
                               "moment_refit"),
        lambda: mt.make_fit(side)(*args, gen))
    check(bool(torch.isfinite(res.homographies).all()), "non-finite H")
    err = evaluation.misclassification_error(res.labels.cpu().numpy(), gt,
                                             cfg.max_labels)
    out["side"] = dict(planes=int(res.active.sum()), misclassification=err,
                       n_far_dropped=int(res.n_far_dropped))
    print(f"side-config stress: planes {out['side']['planes']} of 8, "
          f"misclassification {err:.3f}%, n_far_dropped "
          f"{out['side']['n_far_dropped']}")
    check(out["side"]["planes"] == 8,
          f"side-config stress: {out['side']['planes']} planes of 8")
    return out, launches, side_launches, fused_launches


def phase_motion(dev):
    """Phase 6: one fit a scene of the motion suite's config on fm2_b and
    fm4_a at the golden tau, key 0 (the motion goldens' contract is
    tests/test_torch_motion.py's): the kernels each fit launches."""
    import torch

    import multih_tpu_torch as mt

    print("== 6. the fundamental (multi-motion) fit on the card")
    expect = ("inlier_counts_f", "eig9_smallest", "moment_refit_f",
              "f_accept_step", "mean_field_fused", "icm_fused", "band_list")
    cfg = motion_cfg(512)
    f = mt.make_fit_tau(cfg)
    path = {}
    for name in MOTION_SCENES:
        g = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npz"))
        args = motion_points(name, 512, dev)
        res, fit_launches = count_launches(
            f"motion {name}", expect,
            lambda: f(*args, cpu_draws(0), float(g["inlier_threshold"])))
        check(fit_launches["inlier_counts"] == 0
              and fit_launches["dlt_4pt"] == 0
              and fit_launches["window_gather"] == 0,
              f"motion fit launched a homography-path kernel: "
              f"{fit_launches}")
        check(fit_launches["f_accept_step"] == _accept_ends(cfg),
              f"motion fit: accept ends {fit_launches['f_accept_step']}, "
              f"expected {_accept_ends(cfg)} (2 K an accept)")
        check(bool(torch.isfinite(res.homographies).all()), "non-finite F")
        lab = res.labels.cpu().numpy()
        check(lab.min() >= 0 and lab.max() <= cfg.max_labels, "labels range")
        for kname, c in fit_launches.items():
            path[kname] = path.get(kname, 0) + c
    return path


def phase_adaptive(dev):
    """One two-pass adaptive-threshold fit on tests/test_pipeline.py::
    TestAdaptiveTau's noise-1 px scene (unsolvable at the default tau of
    3 px): tau within (4.5, 7.5), all 3 planes, under 3% error."""
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import data, evaluation

    print("== 7. the adaptive-threshold fit")
    cfg = mt.MultiHConfig(max_points=512, n_hypotheses=2048)
    cs, _ = data.synthetic_scene(400, 3, 0.15, 1.0, seed=117)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 512)
    args = to(dev, x1, x2, valid)
    f = mt.make_fit_adaptive(cfg)
    gen = torch.Generator(device=dev)
    (res, tau), launches = count_launches(
        "adaptive", ("inlier_counts", "dlt_4pt", "eig9_smallest",
                     "moment_refit", "mean_field_fused", "icm_fused",
                     "band_list"),
        lambda: f(*args, gen.manual_seed(0)))
    check(tau.device.type == "cuda", "tau left the card")
    err = evaluation.misclassification_error(res.labels.cpu().numpy(), gt,
                                             cfg.max_labels)
    out = dict(tau=float(tau), planes=int(res.active.sum()),
               misclassification=err)
    print(f"adaptive fit, noise 1 px: tau {out['tau']:.4f} px, planes "
          f"{out['planes']} of 3, misclassification {err:.3f}%")
    check(4.5 < out["tau"] < 7.5, f"adaptive tau {out['tau']}")
    check(out["planes"] == 3 and err < 3.0, f"adaptive fit: {out}")
    return out, launches


def phase_stream(dev):
    """run_stream on the CLI's `stream synth` defaults: SyntheticStream(
    n_frames=30, n_points=480, n_planes=3) at MultiHConfig(max_points=512,
    n_hypotheses=1024), per-frame upload; warm-started and cold, at
    pipeline depths 1 and 3, and warm at depth 3 with the frames
    preloaded. Each run is one path for the launch counts."""
    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import streaming

    print("== 8. the stream (30 frames, 480 points, 3 drifting planes)")
    cfg = mt.MultiHConfig(max_points=512, n_hypotheses=1024)
    out, launches = {}, {}
    for warm, depth, upload in ((True, 1, "stream"), (True, 3, "stream"),
                                (False, 1, "stream"), (False, 3, "stream"),
                                (True, 3, "preload")):
        label = (f"{'warm' if warm else 'cold'}_depth{depth}"
                 + ("_preload" if upload == "preload" else ""))
        st, launches[label] = count_launches(
            f"stream {label}", ("inlier_counts", "dlt_4pt", "eig9_smallest",
                                "moment_refit", "mean_field_fused",
                                "icm_fused", "band_list"),
            lambda: streaming.run_stream(
                streaming.SyntheticStream(n_frames=30, n_points=480,
                                          n_planes=3, seed=0),
                cfg, budget_ms=33.3, seed=0, pipeline_depth=depth,
                warm_start=warm, upload=upload), quiet=True)
        out[label] = dict(frames=st.frames, mean_planes=st.mean_planes)
        print(f"stream {label}: frames {st.frames}, mean planes "
              f"{st.mean_planes:.3f}")
        check(st.frames == 30 and st.mean_planes >= 2.5,
              f"stream {label}: {st}")
    total = {k: sum(c[k] for c in launches.values())
             for k in next(iter(launches.values()))}
    print("kernel launches on the stream path (5 runs):", total)
    return out, total


def _class_counts(res):
    act, is_f = res.active.cpu().numpy(), res.is_f.cpu().numpy()
    return int(act[is_f == 0].sum()), int(act[is_f == 1].sum())


def phase_mixed(dev):
    """The mixed plane + motion fit: one fit each of mx21_a and mx22_b at
    N=1024 (banded stages; the mixed goldens' contract is
    tests/test_torch_mixed.py's on the card), one fit and one adaptive
    fit at N=640 (the gather-path labeling in both stages;
    tests/test_mixed.py's TestMixedScene and TestMixedAdaptiveTau
    cases), and the launches of every fit."""
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import data, evaluation

    print("== 9. the mixed plane + motion fit on the card")
    banded = ("inlier_counts", "inlier_counts_f", "dlt_4pt",
              "eig9_smallest", "moment_refit", "moment_refit_f",
              "f_accept_step", "mean_field_fused", "icm_fused", "band_list")
    cfg_h, cfg_f = mixed_cfgs(1024)
    k_union = cfg_h.max_labels + cfg_f.max_labels
    f = mt.make_fit_mixed(cfg_h, cfg_f)
    path = {}

    def tally(launches, into):
        for kname, c in launches.items():
            into[kname] = into.get(kname, 0) + c

    for name in MIXED_SCENES:
        cs = data.mixed_suite_scene(name)
        args = to(dev, *mt.pad_points(cs.x1, cs.x2, None, 1024))
        # the CPU generator of key 0, as tests/test_torch_mixed.py
        res, fit_launches = count_launches(
            f"mixed {name}", banded, lambda: f(*args, cpu_draws(0)))
        check(fit_launches["mean_field_fused_front"] == 0
              and fit_launches["window_gather"] == 0,
              f"mixed fit launched K6 or K7: {fit_launches}")
        check(fit_launches["f_accept_step"] == _accept_ends(cfg_f),
              f"mixed fit: accept ends {fit_launches['f_accept_step']}, "
              f"expected {_accept_ends(cfg_f)} (2 Kf an accept of the "
              f"motion stage)")
        tally(fit_launches, path)
        check(bool(torch.isfinite(res.models[res.active > 0]).all()),
              "non-finite model")
        lab = res.labels.cpu().numpy()[: cs.n_points]
        check(lab.min() >= 0 and lab.max() <= k_union, "labels range")

    # N=640: no multiple of agree_block 256, so both stages (and the
    # polish, as always) take the gather-path labeling: no band, no list,
    # no K4 / K5
    cfg_h6, cfg_f6 = mixed_cfgs(640)
    gather = {}
    no_band = ("mean_field_fused", "icm_fused", "band_list",
               "mean_field_fused_front", "window_gather", "f_accept_step")
    cs, _, _ = data.synthetic_mixed_scene(600, 2, 1, 0.1, 0.5, seed=4)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 640)
    args = to(dev, x1, x2, valid)
    res, fit_launches = count_launches(
        "mixed N=640 (gather path)", ("inlier_counts", "inlier_counts_f",
                                      "dlt_4pt", "eig9_smallest",
                                      "moment_refit", "moment_refit_f"),
        lambda: mt.make_fit_mixed(cfg_h6, cfg_f6)(*args, cpu_draws(0)))
    check(all(fit_launches[k] == 0 for k in no_band),
          f"gather-path mixed fit launched a band kernel: {fit_launches}")
    tally(fit_launches, gather)
    err = evaluation.misclassification_error(res.labels.cpu().numpy(), gt,
                                             k_union)
    out_640 = dict(counts=_class_counts(res), misclassification=err)
    print(f"mixed N=640 (gather path): (planes, motions) "
          f"{out_640['counts']}, misclassification {err:.3f}%")
    check(out_640["counts"] == (2, 1) and err < 6.0,
          f"mixed N=640: {out_640}")

    cs, _, _ = data.synthetic_mixed_scene(600, 2, 1, 0.1, 1.0, seed=11)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 640)
    args = to(dev, x1, x2, valid)
    (res, tau_h, tau_f), fit_launches = count_launches(
        "mixed adaptive N=640", ("inlier_counts", "inlier_counts_f",
                                 "dlt_4pt", "eig9_smallest",
                                 "moment_refit", "moment_refit_f"),
        lambda: mt.make_fit_mixed_adaptive(cfg_h6, cfg_f6)(
            *args, cpu_draws(0)))
    check(all(fit_launches[k] == 0 for k in no_band),
          f"gather-path adaptive fit launched a band kernel: {fit_launches}")
    tally(fit_launches, gather)
    check(tau_h.device.type == "cuda" and tau_f.device.type == "cuda",
          "taus left the card")
    err = evaluation.misclassification_error(res.labels.cpu().numpy(), gt,
                                             k_union)
    adaptive = dict(tau_h=float(tau_h), tau_f=float(tau_f),
                    counts=_class_counts(res), misclassification=err)
    print(f"mixed adaptive, noise 1 px: tau_h {adaptive['tau_h']:.4f} px, "
          f"tau_f {adaptive['tau_f']:.4f} px, (planes, motions) "
          f"{adaptive['counts']}, misclassification {err:.3f}%")
    check(4.5 < adaptive["tau_h"] < 7.5 and 4.0 < adaptive["tau_f"] < 7.5
          and adaptive["counts"] == (2, 1) and err < 3.0,
          f"mixed adaptive fit: {adaptive}")
    print("kernel launches on the gather-path mixed fits:", gather)
    return dict(n640=out_640, adaptive=adaptive), path, gather


def phase_surfaces(dev):
    """The batch surface, the affine one-point pool, the direct refit and
    the CLI: run_benchmark_batch on the 24 homography golden scenes padded
    to max_points 1024 at the default config with the golden taus (each
    pair >= 97% in agreement with its golden labels and equal to its
    single fit on the card with the same generator); the affine fit
    (tests/test_pipeline.py::TestAffinePath's scene at the default
    config: 2 planes, error < 3%) and its one-point pool against the
    CPU's; the direct-refit fit (refit_moments=False) on BASELINE config
    2 (exact recovery); `multih_tpu_torch.cli synth --json` as a
    subprocess. Each fit path is one entry of the launch counts."""
    import statistics

    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch import MultiHConfig
    from multih_tpu_torch.ops import epipolar
    from multih_tpu_torch.parallel import sharding
    from multih_tpu_torch.utils import evaluation

    print("== 10. the batch surface, the affine pool, the direct refit and "
          "the CLI")
    out, launches = {}, {}
    kernels_h = ("inlier_counts", "dlt_4pt", "eig9_smallest", "moment_refit",
                 "mean_field_fused", "icm_fused", "band_list")

    # the batch: 24 golden scenes at N=1024, one upload, golden taus
    cfg = MultiHConfig(max_points=1024)
    css, taus = golden_batch()
    goldens = [np.load(os.path.join(ROOT, "tests", "goldens",
                                    f"{cs.name}.npz")) for cs in css]
    prepared = sharding.prepare_benchmark_batch(css, cfg, taus=taus,
                                                device=dev)
    (x1, x2, valid, t), _ = prepared
    res, launches["batch"] = count_launches(
        "batch (24 pairs)", kernels_h,
        lambda: sharding.run_benchmark_batch(css, cfg, seed=0,
                                             prepared=prepared))
    check(res.labels.shape == (24, 1024), f"batch labels {res.labels.shape}")
    rows = []
    for i, (cs, g) in enumerate(zip(css, goldens)):
        lab = res.labels[i][:cs.n_points]
        agree = 100.0 - evaluation.misclassification_error(
            lab, g["labels"], cfg.max_labels,
            gt_outlier=int(g["outlier_label"]))
        single = mt.fit(x1[i], x2[i], valid[i],
                        torch.Generator(device=dev).manual_seed(i), cfg,
                        tau=t[i])
        h_diff = float(np.abs(single.homographies.cpu().numpy()
                              - res.homographies[i]).max())
        same = (np.array_equal(single.labels.cpu().numpy(), res.labels[i])
                and np.array_equal(single.active.cpu().numpy(),
                                   res.active[i]) and h_diff == 0.0)
        rows.append(dict(name=cs.name, planes=int(res.active[i].sum()),
                         golden_planes=int(g["n_planes"]), agreement=agree,
                         equals_single=same, h_max_diff_single=h_diff))
        print(f"batch pair {i:2d} {cs.name:12s} tau {taus[i]:.1f}: planes "
              f"{rows[-1]['planes']} (golden {rows[-1]['golden_planes']}), "
              f"agreement with the golden labels {agree:.2f}%, equal to "
              f"its single fit {same} (H max diff {h_diff:.3g})")
        check(agree >= 97.0, f"batch {cs.name}: agreement {agree:.2f}%")
        check(same, f"batch {cs.name}: not its single fit")
    out["pairs"] = rows
    print(f"batch: mean agreement "
          f"{statistics.mean(r['agreement'] for r in rows):.3f}%, all 24 "
          f"equal to their single fits")

    # the affine one-point pool at the default config
    run_affine = affine_fit(dev)
    aargs, acfg = run_affine.args, run_affine.cfg
    ares, launches["affine"] = count_launches("affine", kernels_h, run_affine)
    aerr = evaluation.misclassification_error(ares.labels.cpu().numpy(),
                                              run_affine.gt, acfg.max_labels)
    F = epipolar.estimate_fundamental(cpu_draws(0), *aargs[:3])
    pool_gpu = epipolar.homography_one_point_batch(F, *aargs[:2], aargs[3])
    pool_cpu = epipolar.homography_one_point_batch(
        F.cpu(), *[a.cpu() for a in aargs[:2]], aargs[3].cpu())
    live = (aargs[2] > 0).cpu().numpy()
    pool_diff = float((pool_gpu.cpu() - pool_cpu).abs().numpy()[live].max())
    out["affine"] = dict(planes=int(ares.active.sum()), misclassification=aerr,
                         pool_card_vs_cpu=pool_diff,
                         n_hypotheses_ok=float(ares.n_hypotheses_ok))
    print(f"affine fit, 300 points: planes {out['affine']['planes']}, "
          f"misclassification {aerr:.3f}%, pool {float(ares.n_hypotheses_ok)}"
          f" hypotheses; one-point pool on the card vs the CPU on one F: "
          f"max diff {pool_diff:.3g}")
    check(out["affine"]["planes"] == 2 and aerr < 3.0,
          f"affine fit: {out['affine']}")
    check(bool(torch.isfinite(pool_gpu).all()), "non-finite one-point H")

    # the direct refit: BASELINE config 2, exact recovery
    dcfg = MultiHConfig(max_points=1024, refit_moments=False)
    (planes, err), launches["direct_refit"] = count_launches(
        "direct-refit", ("inlier_counts", "dlt_4pt", "mean_field_fused",
                         "icm_fused", "band_list"),
        lambda: _baseline2(dev, dcfg, torch.Generator(device=dev)))
    out["direct_refit"] = dict(planes=planes, misclassification=err)
    print(f"direct refit, BASELINE config 2: planes {planes}, "
          f"misclassification {err:.4f}% (K3 and refit-kernel launches "
          f"{launches['direct_refit']['eig9_smallest']}, "
          f"{launches['direct_refit']['moment_refit']}: its refits solve "
          f"with eigh)")
    check(planes == 2 and err == 0.0, "direct refit: BASELINE config 2 not "
          "recovered exactly")

    # the CLI, a process of its own on the card
    proc = subprocess.run(
        [sys.executable, "-m", "multih_tpu_torch.cli", "synth", "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"cli synth failed: {proc.stderr[-2000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    out["cli"] = {k: cli[k] for k in ("n_planes_found",
                                      "misclassification_pct")}
    print(f"cli synth --json: planes {cli['n_planes_found']}, "
          f"misclassification {cli['misclassification_pct']:.3f}%")
    check(cli["n_planes_found"] == 2 and cli["misclassification_pct"] < 5.0,
          f"cli synth: {cli}")
    return out, launches, res


# ---------------------------------------------------------------------------
# phase 11: the mesh axes
# ---------------------------------------------------------------------------

MESH_KERNELS = ("inlier_counts", "dlt_4pt", "window_gather")


def _mesh_rank(rank, device):
    """One of phase 11's two gloo ranks on the one card: (a) the stress
    fit with its pool split over a (1, 2) mesh, (b) the motion fit on
    fm4_a the same way, (c) sharded_verification of the stress pool, (d)
    the 24-pair batch on a (2, 1) mesh. Returns what the parent checks,
    as numpy."""
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.models import pipeline
    from multih_tpu_torch.ops.sampling import TorchDraws
    from multih_tpu_torch.ops.topk import top_k_stable
    from multih_tpu_torch.parallel import sharding

    out, launches = {}, {}
    hyp = sharding.make_mesh(pair_axis=1, device=device)
    pair = sharding.make_mesh(device=device)
    gen = torch.Generator(device=device)

    def fit_out(res):
        return {k: getattr(res, k).cpu().numpy()
                for k in ("labels", "active", "n_hypotheses_ok",
                          "homographies")}

    # (a) the stress fit, hyp-sharded
    cfg = stress_cfg()
    args = stress_points(device)
    f = sharding.hyp_sharded_fit(cfg, hyp)
    res, launches["mesh_stress"] = count_launches(
        f"mesh stress rank {rank}", MESH_KERNELS,
        lambda: f(*args, gen.manual_seed(0)), quiet=True)
    out["stress"] = fit_out(res)
    xs = hv_inputs(cfg, *args)
    out["hv_cand"] = pipeline._hypothesize_verify_sharded(
        TorchDraws(gen.manual_seed(0)), *xs, cfg, None, hyp,
        window_block=cfg.agree_block)[1].cpu().numpy()

    # (b) the motion fit on fm4_a, hyp-sharded
    mcfg = motion_cfg(512)
    margs = motion_points("fm4_a", 512, device)
    fm = sharding.hyp_sharded_fit(mcfg, hyp)
    res, launches["mesh_motion"] = count_launches(
        f"mesh motion rank {rank}", ("inlier_counts_f",),
        lambda: fm(*margs, gen.manual_seed(0)), quiet=True)
    out["motion"] = fit_out(res)

    # (c) sharded verification of the stress pool
    Hs, _ = pipeline.generate_hypotheses(
        TorchDraws(gen.manual_seed(0)), *xs, cfg,
        window_block=cfg.agree_block)
    verify = sharding.sharded_verification(cfg, hyp, replication_check=True)
    c, i, ok = verify(Hs, *xs[:3])
    counts = pipeline.count_inliers(Hs, *xs[:3], cfg)
    rc, ri = top_k_stable(counts, cfg.n_candidates)
    out["verify"] = dict(
        pool=Hs.shape[0], equal=bool(torch.equal(c, rc)
                                     and torch.equal(i, ri)),
        replicated=float(ok))

    # (d) the 24 golden scenes on a (2, 1) mesh: 12 pairs a rank
    bcfg = mt.MultiHConfig(max_points=1024)
    css, taus = golden_batch()
    prepared = sharding.prepare_benchmark_batch(css, bcfg, taus=taus,
                                                mesh=pair)
    bres, launches["mesh_batch"] = count_launches(
        f"mesh batch rank {rank}", ("inlier_counts", "dlt_4pt"),
        lambda: sharding.run_benchmark_batch(css, bcfg, seed=0,
                                             prepared=prepared, mesh=pair),
        quiet=True)
    out["batch"] = bres._asdict()
    out["launches"] = launches
    return out


def _nccl_rank(rank, device):
    """(e): sharded_verification of the stress pool on a one-rank NCCL
    mesh, so that NCCL's all_gather runs on the card."""
    import torch
    import torch.distributed as dist

    from multih_tpu_torch.models import pipeline
    from multih_tpu_torch.ops.sampling import TorchDraws
    from multih_tpu_torch.ops.topk import top_k_stable
    from multih_tpu_torch.parallel import sharding

    m = sharding.make_mesh(device=device)
    cfg = stress_cfg()
    xs = hv_inputs(cfg, *stress_points(device))
    Hs, _ = pipeline.generate_hypotheses(
        TorchDraws(torch.Generator(device=device).manual_seed(0)), *xs, cfg,
        window_block=cfg.agree_block)
    c, i, ok = sharding.sharded_verification(cfg, m, True)(Hs, *xs[:3])
    rc, ri = top_k_stable(pipeline.count_inliers(Hs, *xs[:3], cfg),
                          cfg.n_candidates)
    return dict(backend=dist.get_backend(), shape=m.shape,
                equal=bool(torch.equal(c, rc) and torch.equal(i, ri)),
                replicated=float(ok), staged=m.host_staged)


def phase_mesh(dev, batch):
    """Phase 11: the 'pair' and 'hyp' mesh axes, two gloo ranks sharing
    the one card (NCCL refuses two ranks on one device; gloo gathers CUDA
    tensors through the host), then one NCCL rank. Each rank's results
    against this process's single-device fits on the card."""
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.models import pipeline
    from multih_tpu_torch.ops.sampling import TorchDraws
    from multih_tpu_torch.parallel import mesh

    print("== 11. the mesh: a (1, 2) and a (2, 1) mesh of two gloo ranks "
          "on the one card, and a one-rank NCCL mesh")
    gen = torch.Generator(device=dev)
    cfg = stress_cfg()
    args = stress_points(dev)
    ref = mt.fit(*args, gen.manual_seed(0), cfg)
    xs = hv_inputs(cfg, *args)
    ref_cand = pipeline._hypothesize_verify(
        TorchDraws(gen.manual_seed(0)), *xs, cfg, None, [], [],
        cfg.agree_block)[0].cpu().numpy()
    mcfg = motion_cfg(512)
    mref = mt.fit(*motion_points("fm4_a", 512, dev), gen.manual_seed(0),
                  mcfg)
    ranks = mesh.spawn(_mesh_rank, 2, "gloo", lambda r: "cuda:0",
                       timeout_s=400.0)
    nccl = mesh.spawn(_nccl_rank, 1, "nccl", lambda r: "cuda:0",
                      timeout_s=180.0)[0]
    out, launches = dict(verify=[], nccl=nccl), {}
    for r, got in enumerate(ranks):
        for label, want in (("stress", ref), ("motion", mref)):
            g = got[label]
            h_diff = float(np.abs(g["homographies"]
                                  - want.homographies.cpu().numpy()).max())
            same = all(np.array_equal(g[k], getattr(want, k).cpu().numpy())
                       for k in ("labels", "active", "n_hypotheses_ok"))
            print(f"rank {r} {label} fit on the (1, 2) mesh: planes "
                  f"{int(g['active'].sum())}, labels / active / "
                  f"n_hypotheses_ok equal to the single card fit {same}, "
                  f"H max diff {h_diff:.3g}")
            check(same, f"rank {r} {label}: not the single fit")
            np.testing.assert_allclose(g["homographies"],
                                       want.homographies.cpu().numpy(),
                                       rtol=2e-4, atol=2e-5)
        check(int(got["stress"]["active"].sum()) == 8,
              f"rank {r}: {int(got['stress']['active'].sum())} planes of 8")
        cand_diff = float(np.abs(got["hv_cand"] - ref_cand).max())
        check(cand_diff <= 2e-5 + 2e-4 * float(np.abs(ref_cand).max()),
              f"rank {r}: candidates {cand_diff:.3g} from the single pick")
        v = got["verify"]
        print(f"rank {r} sharded_verification of the {v['pool']}-hypothesis "
              f"stress pool: equal to the unsharded stable top-"
              f"{cfg.n_candidates} {v['equal']}, replicated "
              f"{v['replicated']}; candidates {cand_diff:.3g} from the "
              f"single pick")
        check(v["equal"] and v["replicated"] == 1.0,
              f"rank {r}: sharded verification {v}")
        out["verify"].append(v)
        for name, a in batch._asdict().items():
            check(np.array_equal(got["batch"][name], a),
                  f"rank {r}: (2, 1) batch {name} not phase 10's batch")
        for path, c in got["launches"].items():
            launches[f"{path}_r{r}"] = c
        ml = got["launches"]["mesh_stress"]
        print(f"rank {r} launches, sharded stress fit: K1 "
              f"{ml['inlier_counts']}, K2 {ml['dlt_4pt']}, K7 "
              f"{ml['window_gather']} (all: {ml}); motion K1 (f_) "
              f"{got['launches']['mesh_motion']['inlier_counts_f']}; batch "
              f"(12 pairs) K1 {got['launches']['mesh_batch']['inlier_counts']}")
    check(all(np.array_equal(ranks[0]["batch"][k], ranks[1]["batch"][k])
              for k in ranks[0]["batch"]), "the ranks' batches differ")
    print("24-pair batch on the (2, 1) mesh: all 24 pairs equal to phase "
          "10's batch on both ranks")
    print(f"NCCL one-rank mesh {nccl['shape']} ({nccl['backend']}): "
          f"sharded_verification equal {nccl['equal']}, replicated "
          f"{nccl['replicated']}, host-staged bytes {nccl['staged']}")
    check(nccl["equal"] and nccl["replicated"] == 1.0
          and nccl["staged"] == 0, f"NCCL mesh: {nccl}")
    return out, launches


def _pt_cells(device):
    """Phase 12's cells, each a dict of name, cfg, args ((x1, x2, valid)
    on `device`), gt (padded ground-truth labels), key (returns the
    fit's key in its start state; every rank and the single fit take the
    same) and golden (a golden misclassification, or None):
      baseline2    BASELINE config 2 at the default config (N = 1024,
                   4 blocks of 256);
      stress       phase 5's scene at the stress settings (N = 10240, 80
                   blocks of 128);
      fm4_a        the motion suite's config (tests/test_golden_parity.py
                   :144-148) at the golden tau, N = 512, CPU key 0, held
                   to the motion bound;
      motion_full  the F model at full width: 10000 points, 4 motions,
                   30% outliers, N = 10240 at agree_block 128 (40 blocks
                   a rank), the motion suite's config otherwise;
      exact        BASELINE config 2 at the side config (the exact graph,
                   whose far edges a sweep gathers; no K4 or K5);
      exact_near   500 noise-free points, 2 planes, at the side config and
                   N = 512 (a block a rank): the exact graph with no far
                   edge, so each rank builds its window's list once and
                   sweeps with K4 and K5, where the single fit (whose
                   general band carries no list) sweeps plainly."""
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import data

    def cuda_key():
        return torch.Generator(device=device).manual_seed(0)

    g = np.load(os.path.join(ROOT, "tests", "goldens", "fm4_a.npz"))
    baseline2 = data.synthetic_scene(1000, 2, 0.0, 0.0)[0]
    rows = (
        ("baseline2", 1024, mt.MultiHConfig(max_points=1024), baseline2,
         cuda_key, None),
        ("stress", 10240, stress_cfg(),
         data.synthetic_scene(10000, 8, 0.7, 0.5, seed=42)[0], cuda_key,
         None),
        ("fm4_a", 512, dataclasses.replace(
            motion_cfg(512), inlier_threshold=float(g["inlier_threshold"])),
         data.motion_suite_scene("fm4_a"), lambda: cpu_draws(0),
         float(g["misclassification"])),
        ("motion_full", 10240,
         dataclasses.replace(motion_cfg(10240), agree_block=128),
         data.synthetic_motion_scene(10000, 4, 0.3, 0.5, seed=42)[0],
         cuda_key, None),
        ("exact", 1024, _slice_cfg(max_points=1024), baseline2, cuda_key,
         None),
        ("exact_near", 512, _slice_cfg(max_points=512),
         data.synthetic_scene(500, 2, 0.0, 0.0, seed=7)[0], cuda_key, None),
    )
    out = []
    for name, n_pad, cfg, scene, key, golden in rows:
        x1, x2, valid, gt = mt.pad_points(scene.x1, scene.x2,
                                          scene.gt_labels, n_pad)
        out.append(dict(name=name, cfg=cfg, args=to(device, x1, x2, valid),
                        gt=gt, key=key, golden=golden))
    return out


def _pt_expected(cfg, single: dict) -> dict:
    """Each kernel's launches in one 'pt' rank's fit, from the single
    card fit's (`single`): K4 a launch a mean-field sweep and K5 one an
    ICM half-sweep where the single fit launches each once a call (none
    on the exact graph's band, in either), no accept end (a 'pt' shard
    takes the accept's plain loop, whose relabels launch K5 as the ends'
    steps do), every other kernel as often as in the single fit (the
    refits gather their weights and refit whole; each rank counts its
    own points, once a sweep)."""
    factor = {"mean_field_fused": cfg.meanfield_iterations,
              "icm_fused": 2 * cfg.icm_iterations, "f_accept_step": 0}
    return {k: n * factor.get(k, 1) for k, n in single.items()}


def _pt_sweep_inputs(device):
    """K4's and K5's inputs at the stress shape (N = 10240, B = 128,
    L = 17, 2 starts, 4 sweeps, 1 ICM iteration), from a generator of
    their own: the stress scene's Morton-sorted positions and valid mask,
    q0 softmax rows, base, int32 starts, inverse temperatures."""
    from multih_tpu_torch.models import pipeline

    x1, _, valid = stress_points(device)
    perm = pipeline.morton_order(x1, valid)
    rng = np.random.default_rng(1212)
    base = rng.uniform(0.0, 4.0, (17, 10240)).astype(np.float32)
    q0 = np.exp(-base)
    q0 /= q0.sum(0)
    starts = rng.integers(0, 17, (2, 10240), dtype=np.int32)
    inv_t = (1.0 / np.geomspace(3.0, 0.5, 4)).astype(np.float32)
    return (x1[perm], valid[perm], *to(device, q0, base, starts, inv_t))


def _pt_graphs(cfg, x1, x2, valid, mesh=None) -> list:
    """The fit's two k-NN graphs (positions; the sampling features), the
    windowed or the exact one as the fit builds it, on the Morton-sorted
    points as numpy: every row, or with `mesh` a 'pt' rank's own rows."""
    import torch

    from multih_tpu_torch.models import labeling, pipeline

    perm = pipeline.morton_order(x1, valid)
    x1, x2, valid = x1[perm], x2[perm], valid[perm]
    windowed = pipeline.graph_path(cfg, x1.shape[0]) == "windowed"
    rows = None
    if mesh is not None:
        shard = labeling.PointShard(mesh, x1.shape[0], cfg.agree_block)
        rows = (shard.lo, shard.hi)

    def graph(f):
        if windowed:
            return labeling.knn_graph_windowed(f, valid, cfg.knn_k,
                                               cfg.agree_block, rows)
        return labeling.knn_graph(f, valid, cfg.knn_k, cfg.knn_row_block,
                                  cfg.knn_approx, rows)

    feat = torch.cat([x1, cfg.sampling_motion_weight * (x2 - x1)], dim=1)
    return [graph(x1)[0].cpu().numpy(), graph(feat)[0].cpu().numpy()]


def _pt_rank(rank, device):
    """One of phase 12's two gloo ranks on the one card: each cell's fit
    on a (pt=2) mesh (its k-NN rows and launches), then K4 and K5 on the
    rank's window at the stress shape, a launch a sweep with the halo
    exchanged between launches."""
    import torch

    from multih_tpu_torch.models import labeling
    from multih_tpu_torch.ops.kernels import mrf_kernel
    from multih_tpu_torch.parallel import sharding

    m = sharding.make_pt_mesh(device=device)
    out = {}
    for c in _pt_cells(device):
        name, args, key = c["name"], c["args"], c["key"]
        out[f"{name}_graphs"] = _pt_graphs(c["cfg"], *args, m)
        f = sharding.pt_sharded_fit(c["cfg"], m)
        f(*args, key())  # warm: the library loads once
        res, launches = count_launches(
            f"pt {name} rank {rank}", (), lambda: f(*args, key()),
            quiet=True)
        out[name] = dict(
            labels=res.labels.cpu().numpy(), active=res.active.cpu().numpy(),
            energy=float(res.energy), launches=launches,
            n_far_dropped=int(res.n_far_dropped))

    x1, valid, q0, base, starts, inv_t = _pt_sweep_inputs(device)
    shard = labeling.PointShard(m, 10240, 128)
    nbr, w = labeling.knn_graph_windowed(x1, valid, 6, 128,
                                         (shard.lo, shard.hi))
    adj = labeling.build_window_adjacency(nbr, w, shard, neighbour_list=True)
    own = slice(shard.lo, shard.hi)
    mrf_kernel.mean_field_fused.launches = mrf_kernel.icm_fused.launches = 0
    q = mrf_kernel.mean_field_windowed(
        q0[:, own].contiguous(), base[:, own].contiguous(), adj.band, inv_t,
        0.7, shard.window, nbr=adj.nbr)
    lab = mrf_kernel.icm_windowed(
        starts[:, own].contiguous(), base[:, own].contiguous(), adj.band, 1,
        0.7, shard.window, nbr=adj.nbr)
    torch.cuda.synchronize()
    launches = dict(mean_field_fused=mrf_kernel.mean_field_fused.launches,
                    icm_fused=mrf_kernel.icm_fused.launches)
    out["sweeps"] = dict(lo=shard.lo, hi=shard.hi, q=q.cpu().numpy(),
                         labels=lab.cpu().numpy(), launches=launches)
    return out


def phase_pt(dev):
    """Phase 12: the 'pt' (point) axis, two gloo ranks sharing the one
    card (NCCL refuses two ranks on one device), each owning half of the
    Morton blocks. Each cell's sharded fit against this process's single
    card fit; K4's and K5's own blocks against the unsharded launch."""
    import multih_tpu_torch as mt
    from multih_tpu_torch.models import labeling
    from multih_tpu_torch.ops.kernels import mrf_kernel
    from multih_tpu_torch.parallel import mesh
    from multih_tpu_torch.utils import evaluation

    print("== 12. the 'pt' (point) axis: a (pt=2) mesh of two gloo ranks "
          "on the one card; BASELINE config 2 (N=1024), the stress cell "
          "(N=10240), the F model on fm4_a (N=512) and at full width "
          "(N=10240), BASELINE config 2 on the exact graph, and the exact "
          "graph with no far edge (N=512)")
    single = {}
    for c in _pt_cells(dev):
        name, cfg, args, key = c["name"], c["cfg"], c["args"], c["key"]
        ref, launches = count_launches(f"single {name}", (),
                                       lambda: mt.fit(*args, key(), cfg),
                                       quiet=True)
        single[name] = dict(c, ref=ref, launches=launches)
    x1, valid, q0, base, starts, inv_t = _pt_sweep_inputs(dev)
    nbr, w = labeling.knn_graph_windowed(x1, valid, 6, 128)
    adj = labeling.build_banded_adjacency(nbr, w, 128, far_capacity=0,
                                          neighbour_list=True)
    q_full = mrf_kernel.mean_field_fused(q0, base, adj.band, inv_t, 0.7,
                                         nbr=adj.nbr).cpu().numpy()
    lab_full = mrf_kernel.icm_fused(starts, base, adj.band, 1, 0.7,
                                    nbr=adj.nbr).cpu().numpy()
    ranks = mesh.spawn(_pt_rank, 2, "gloo", lambda r: "cuda:0",
                       timeout_s=900.0)
    out, launches = {"cells": {}}, {}
    for name, s in single.items():
        ref, cfg = s["ref"], s["cfg"]
        want = _pt_expected(cfg, s["launches"])
        graphs = _pt_graphs(cfg, *s["args"])
        n_own = cfg.max_points // 2
        k1 = ("inlier_counts_f" if cfg.model == "fundamental"
              else "inlier_counts")
        refit = ("moment_refit_f" if cfg.model == "fundamental"
                 else "moment_refit")
        # K4 / K5 sweep a rank's far-free band: the windowed graph's, and
        # the exact graph's where no edge is far (its list built once)
        mrf = cfg.knn_window or name == "exact_near"
        cell = dict(single_launches=s["launches"], ranks=[])
        for r, got in enumerate(ranks):
            g = got[name]
            lc = g["launches"]
            if name == "exact_near":
                check(lc["mean_field_fused"] > 0 and lc["icm_fused"] > 0
                      and lc["mean_field_fused"] % cfg.meanfield_iterations
                      == 0 and lc["icm_fused"] % (2 * cfg.icm_iterations)
                      == 0, f"rank {r} {name}: K4 {lc['mean_field_fused']}, "
                      f"K5 {lc['icm_fused']}: not a launch a sweep")
                want = dict(want, mean_field_fused=lc["mean_field_fused"],
                            icm_fused=lc["icm_fused"], band_list=1)
            graph_eq = all(np.array_equal(
                mine, full[r * n_own:(r + 1) * n_own])
                for mine, full in zip(got[f"{name}_graphs"], graphs))
            n_diff = int((g["labels"] != ref.labels.cpu().numpy()).sum())
            lab_eq = n_diff == 0
            act_eq = bool(np.array_equal(g["active"],
                                         ref.active.cpu().numpy()))
            drop_eq = g["n_far_dropped"] == int(ref.n_far_dropped)
            gap = abs(g["energy"] - float(ref.energy)) / abs(float(ref.energy))
            err = evaluation.misclassification_error(
                g["labels"], s["gt"], cfg.max_labels)
            print(f"rank {r} {name}: k-NN rows (both graphs) equal to the "
                  f"unsharded rows {graph_eq}; labels equal to the single "
                  f"card fit {lab_eq} ({n_diff} of {cfg.max_points} "
                  f"differ), active equal {act_eq}, n_far_dropped "
                  f"{g['n_far_dropped']} (single {int(ref.n_far_dropped)}),"
                  f" energy rel. gap {gap:.3g}, models "
                  f"{int(g['active'].sum())}, misclassification "
                  f"{err:.3f}%; launches K1 {lc[k1]} (single "
                  f"{s['launches'][k1]}), K3 {lc['eig9_smallest']} (single "
                  f"{s['launches']['eig9_smallest']}), refit kernels "
                  f"{lc[refit]} (single {s['launches'][refit]}), K4 "
                  f"{lc['mean_field_fused']} (single "
                  f"{s['launches']['mean_field_fused']}), K5 "
                  f"{lc['icm_fused']} (single {s['launches']['icm_fused']}),"
                  f" list {lc['band_list']}")
            check(graph_eq and lab_eq and act_eq and drop_eq,
                  f"rank {r} {name}: {n_diff} labels differ, active "
                  f"{act_eq}, graph {graph_eq}, n_far_dropped {drop_eq}")
            check(gap <= 1e-3, f"rank {r} {name}: energy gap {gap:.3g}")
            check(lc == want, f"rank {r} {name}: launches {lc}, expected "
                  f"{want} (the single fit's, K4 a launch a sweep, K5 one "
                  f"a half-sweep)")
            # no K4 or K5 on the exact graph's band with far edges
            for k in ((k1, "eig9_smallest", refit, "mean_field_fused",
                       "icm_fused") if mrf else (k1, "eig9_smallest", refit)):
                check(lc[k] > 0, f"rank {r} {name}: {k} never launched")
            if s["golden"] is not None:
                delta = err - s["golden"]
                print(f"  {name} rank {r}: misclassification {err:.3f}% "
                      f"against the golden {s['golden']:.3f}%, delta "
                      f"{delta:+.3f} pp (bound 2.0)")
                check(abs(delta) <= 2.0, f"rank {r} {name}: delta "
                      f"{delta:+.3f} pp past the motion bound")
            launches[f"pt_{name}_r{r}"] = lc
            cell["ranks"].append(dict(
                labels_equal=lab_eq, labels_differing=n_diff,
                graph_equal=graph_eq, active_equal=act_eq,
                n_far_dropped=g["n_far_dropped"], energy_gap=gap,
                misclassification=err, launches=lc))
        out["cells"][name] = cell
    sweeps = []
    for r, got in enumerate(ranks):
        sw = got["sweeps"]
        own = slice(sw["lo"], sw["hi"])
        q_eq = bool(np.array_equal(sw["q"], q_full[:, own]))
        l_eq = bool(np.array_equal(sw["labels"], lab_full[:, own]))
        print(f"rank {r} K4 / K5 on its window (points {sw['lo']}-"
              f"{sw['hi'] - 1} + a halo block a side, N=10240 B=128 L=17): "
              f"own blocks bit-equal to the unsharded launch: K4 {q_eq}, "
              f"K5 {l_eq}; launches {sw['launches']}")
        check(q_eq and l_eq, f"rank {r}: windowed K4 / K5 not bit-equal")
        check(sw["launches"] == {"mean_field_fused": 4, "icm_fused": 2},
              f"rank {r}: windowed launches {sw['launches']}")
        sweeps.append(dict(k4_bit_equal=q_eq, k5_bit_equal=l_eq,
                           launches=sw["launches"]))
    out["sweeps"] = sweeps
    return out, launches


def _dryrun_rank(rank, device):
    """One of phase 13's gloo ranks: tools/torch_dryrun_multichip.py's
    rank function, its kernel launches counted."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_dryrun_multichip as dryrun

    return count_launches(
        f"dryrun rank {rank}", ("inlier_counts", "inlier_counts_f",
                                "dlt_4pt", "eig9_smallest", "moment_refit",
                                "moment_refit_f", "mean_field_fused",
                                "icm_fused", "band_list"),
        lambda: dryrun.dryrun_rank(rank, device, 2), quiet=True)


def phase_dryrun():
    """Phase 13: the port's dryrun_multichip (tools/torch_dryrun_multichip
    .py) on two gloo ranks sharing the card: every mesh path at the
    reference's tiny shapes, asserted on known labels in the ranks."""
    from multih_tpu_torch.parallel import mesh

    print("== 13. dryrun_multichip: every mesh path on two gloo ranks on "
          "the one card")
    ranks = mesh.spawn(_dryrun_rank, 2, "gloo", lambda r: "cuda:0",
                       timeout_s=600.0)
    res = [r[0] for r in ranks]
    for r, got in enumerate(res):
        check(got == res[0], f"dryrun rank {r}: {got}, rank 0 {res[0]}")
    print(f"dryrun_multichip OK on 2 gloo ranks: {res[0]}; launches by "
          f"rank {[r[1] for r in ranks]}")
    launches = {f"dryrun_r{r}": lc for r, (_, lc) in enumerate(ranks)}
    return res[0], launches


# ---------------------------------------------------------------------------
# phase 14: the homography fit's kinds captured as CUDA graphs (utils/aot.py)
# ---------------------------------------------------------------------------

# the kernels' symbols in a profile of a replay -> their wrappers' names
AOT_SYMBOLS = (("count_kernel", "inlier_counts"), ("dlt_gt", "dlt_4pt"),
               ("eig_kernel", "eig9_smallest"), ("band_list", "band_list"),
               ("mf_grid", "mean_field_fused"), ("icm_grid", "icm_fused"),
               ("mf_front_grid", "mean_field_fused_front"),
               ("window_gather_kernel", "window_gather"))
K15 = ("inlier_counts", "dlt_4pt", "eig9_smallest", "mean_field_fused",
       "icm_fused", "band_list")


def _aot_cell(label, cfg, kind, pts, extra, expect, profiled=False,
              mixed=None, forbid=(), golden=None):
    """One cell of phase 14: the eager maker and the captured fit of
    `kind` at cfg (with `mixed`, the mixed fit's cfg_f, cfg being cfg_h),
    on pts with the kind's other arguments `extra`; the kernels a replay
    must launch (`expect`) and must not (`forbid`); whether the
    profiler's kernels of a replay are held to the capture's
    (`profiled`); a mixed cell's golden scene."""
    from multih_tpu_torch.models import mixed as mixed_fit
    from multih_tpu_torch.models import pipeline
    from multih_tpu_torch.utils import aot

    if mixed is None:
        maker = {"fit": pipeline.make_fit, "fit_tau": pipeline.make_fit_tau,
                 "fit_seeded": pipeline.make_fit_seeded,
                 "fit_adaptive": pipeline.make_fit_adaptive}[kind](cfg)

        def cached(dev):
            return aot.cached_fit(cfg, kind, device=dev)
    else:
        maker = {"fit": mixed_fit.make_fit_mixed,
                 "fit_tau": mixed_fit.make_fit_mixed_tau,
                 "fit_adaptive": mixed_fit.make_fit_mixed_adaptive}[kind](
                     cfg, mixed)

        def cached(dev):
            return aot.cached_fit_mixed(cfg, mixed, kind=kind, device=dev)
    return dict(label=label, cfg=cfg, kind=kind, pts=pts, extra=extra,
                expect=expect, forbid=forbid, profiled=profiled, maker=maker,
                cached=cached, mixed=mixed is not None, golden=golden)


def _aot_cases(dev):
    """Phase 14's cells (`_aot_cell`): the homography fit's, then the
    motion fit's and the mixed fit's."""
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch import MultiHConfig
    from multih_tpu_torch.utils import data, streaming

    easy = suite_points(data.suite_scene("easy2_a"), 512, dev)
    tau = float(np.load(os.path.join(ROOT, "tests", "goldens",
                                     "easy2_a.npz"))["inlier_threshold"])
    cs, _ = data.synthetic_scene(1000, 2, 0.0, 0.0)
    base2 = to(dev, *mt.pad_points(cs.x1, cs.x2, None, 1024))
    stress = stress_points(dev)
    cs, _ = data.synthetic_scene(400, 3, 0.15, 1.0, seed=117)
    noisy = to(dev, *mt.pad_points(cs.x1, cs.x2, None, 512))
    # the stream's second frame, seeded with the first frame's planes
    scfg = MultiHConfig(max_points=512, n_hypotheses=1024)
    frames = [suite_points(f, 512, dev) for f in streaming.SyntheticStream(
        n_frames=2, n_points=480, n_planes=3, seed=0)]
    prev = mt.make_fit_seeded(scfg)(
        *frames[0], torch.Generator(device=dev).manual_seed(0),
        torch.eye(3, device=dev).expand(scfg.max_labels, 3, 3),
        torch.zeros((scfg.max_labels,), device=dev))
    k7 = K15 + ("window_gather",)
    # the motion fit at the motion suite's config on fm4_a (K1 at
    # f_sampson, K3, K4, K5, the list; no K2), and the mixed fit at the
    # mixed goldens' configs on mx21_a: N=1024 (banded stages) and N=640
    # (the gather-path labeling: K1-K3 only)
    mcfg = motion_cfg(512)
    fm4 = motion_points("fm4_a", 512, dev)
    fm_tau = float(np.load(os.path.join(ROOT, "tests", "goldens",
                                        "fm4_a.npz"))["inlier_threshold"])
    f_only = ("inlier_counts_f", "eig9_smallest", "mean_field_fused",
              "icm_fused", "band_list")
    mx = data.mixed_suite_scene("mx21_a")
    mx_tau = float(np.load(os.path.join(ROOT, "tests", "goldens",
                                        "mx21_a.npz"))["inlier_threshold"])
    mx1024 = to(dev, *mt.pad_points(mx.x1, mx.x2, None, 1024))
    mx640 = to(dev, *mt.pad_points(mx.x1, mx.x2, None, 640))
    banded = ("inlier_counts", "inlier_counts_f", "dlt_4pt", "eig9_smallest",
              "mean_field_fused", "icm_fused", "band_list")
    no_band = ("mean_field_fused", "icm_fused", "band_list",
               "mean_field_fused_front", "window_gather")
    h1024, f1024 = mixed_cfgs(1024)
    h640, f640 = mixed_cfgs(640)
    cell = _aot_cell
    return [
        cell("fit N=512", MultiHConfig(max_points=512), "fit", easy, (), K15,
             profiled=True),
        cell("fit N=1024 BASELINE 2", MultiHConfig(max_points=1024), "fit",
             base2, (), K15, profiled=True),
        cell("fit fused front", MultiHConfig(max_points=512,
                                             mrf_fused_front=True), "fit",
             easy, (), ("inlier_counts", "dlt_4pt", "eig9_smallest",
                        "mean_field_fused_front", "icm_fused",
                        "band_list")),
        cell("fit stress", stress_cfg(), "fit", stress, (), k7,
             profiled=True),
        cell("fit_tau", MultiHConfig(max_points=512), "fit_tau", easy,
             (tau,), K15),
        cell("fit_seeded", scfg, "fit_seeded", frames[1],
             (prev.homographies, prev.active), K15),
        cell("fit_adaptive", MultiHConfig(max_points=512), "fit_adaptive",
             noisy, (), K15),
        cell("motion fit fm4_a", mcfg, "fit", fm4, (), f_only, profiled=True,
             forbid=("dlt_4pt", "window_gather")),
        cell("motion fit_tau fm4_a", mcfg, "fit_tau", fm4, (fm_tau,),
             f_only, forbid=("dlt_4pt", "window_gather")),
        cell("motion fit_adaptive fm4_a", mcfg, "fit_adaptive", fm4, (),
             f_only, forbid=("dlt_4pt", "window_gather")),
        cell("mixed fit mx21_a N=1024", h1024, "fit", mx1024, (), banded,
             profiled=True, mixed=f1024, golden="mx21_a"),
        cell("mixed fit_tau mx21_a N=1024", h1024, "fit_tau", mx1024,
             (mx_tau, mx_tau), banded, mixed=f1024, golden="mx21_a"),
        cell("mixed fit_adaptive mx21_a N=1024", h1024, "fit_adaptive",
             mx1024, (), banded, mixed=f1024, golden="mx21_a"),
        cell("mixed fit mx21_a N=640 (gather path)", h640, "fit", mx640, (),
             ("inlier_counts", "inlier_counts_f", "dlt_4pt",
              "eig9_smallest"), mixed=f640, forbid=no_band,
             golden="mx21_a"),
    ]


def _fit_diff(a, b, name: str = "") -> list:
    """The leaves in which two fit results (a FitResult or MixedFitResult,
    or a tuple of results and taus) differ, bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [name or "tensor"]
    if hasattr(a, "_fields"):
        return [d for n in a._fields for d in _fit_diff(
            getattr(a, n), getattr(b, n), f"{name}.{n}" if name else n)]
    return [d for i, (x, y) in enumerate(zip(a, b))
            for d in _fit_diff(x, y, f"{name}[{i}]")]


def _mixed_contract(results, golden: str) -> dict:
    """The mixed goldens' contract on fit results (MixedFitResult, or the
    adaptive fit's tuples) of `golden`'s scene: class counts exact on
    every result, the mean misclassification within 3.5 pp."""
    from multih_tpu_torch.utils import data, evaluation

    g = np.load(os.path.join(ROOT, "tests", "goldens", f"{golden}.npz"))
    cs = data.mixed_suite_scene(golden)
    g_f = int(g["n_fundamental"])
    want = (int(g["n_planes"]) - g_f, g_f)
    counts, errs = [], []
    for res in results:
        res = res if hasattr(res, "_fields") else res[0]
        k_union = res.models.shape[0]
        counts.append(_class_counts(res))
        errs.append(evaluation.misclassification_error(
            res.labels.cpu().numpy()[:cs.n_points], cs.gt_labels, k_union))
    delta = float(np.mean(errs)) - float(g["misclassification"])
    check(all(c == want for c in counts) and abs(delta) <= 3.5,
          f"{golden}: replays' class counts {counts} (golden {want}), "
          f"delta {delta:+.3f} pp")
    return dict(counts=counts, misclassification=errs, delta=delta)


def _sync_sites(fn) -> dict:
    """{file:line: count} of every synchronizing CUDA call fn() makes
    (torch.cuda.set_sync_debug_mode("warn")): host reads of device
    values and host-to-device copies from pageable memory, which a CUDA
    graph cannot capture."""
    import collections
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)))


def _replay_kernels(fn) -> dict | None:
    """{kernel: launches} of the port's kernels in one replay of fn, from
    the profiler's device events (None where no profile came back)."""
    n, names = cc.cuda_launches(fn, calls=1)
    if n is None:
        return None
    kernels = {}
    for name in names:
        for sym, kernel in AOT_SYMBOLS:
            if sym in name:
                kernels[kernel] = kernels.get(kernel, 0) + 1
    return kernels


def _aot_cold_starts() -> dict:
    """`python -m multih_tpu_torch.cli synth --json` in a fresh process:
    with --aot on an empty cache root (the kernel build + the captures),
    again on the filled root (load + captures), and without --aot on the
    default build (load, eager fits); the --aot runs' results equal the
    plain run's (a replay is the eager fit)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="aot_cold_", dir=os.path.join(ROOT,
                                                                 "build"))
    out = {}
    try:
        for label, extra, env in (
                ("aot_empty", ["--aot"], {"MULTIH_AOT_CACHE": root}),
                ("aot_filled", ["--aot"], {"MULTIH_AOT_CACHE": root}),
                ("plain", [], {})):
            env = dict({k: v for k, v in os.environ.items()
                        if k != "MULTIH_AOT_CACHE"}, MULTIH_AOT="", **env)
            proc = subprocess.run(
                [sys.executable, "-m", "multih_tpu_torch.cli", "synth",
                 "--json", *extra], cwd=ROOT, env=env, capture_output=True,
                text=True, timeout=600)
            check(proc.returncode == 0,
                  f"cli synth {extra}: {proc.stderr[-2000:]}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            out[label] = res
            print(f"cli synth --json {' '.join(extra)} ({label}): planes "
                  f"{res['n_planes_found']}, misclassification "
                  f"{res['misclassification_pct']:.3f}%")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for label in ("aot_empty", "aot_filled"):
        for key in ("n_planes_found", "support", "homographies", "energy",
                    "misclassification_pct"):
            check(out[label][key] == out["plain"][key],
                  f"cli synth --aot ({label}) {key} differs from the plain "
                  f"run's")
    return {k: {kk: v[kk] for kk in ("n_planes_found",
                                     "misclassification_pct")}
            for k, v in out.items()}


def _aot_cli_models() -> dict:
    """`python -m multih_tpu_torch.cli synth --model fundamental|mixed
    --json --aot` in a fresh process, and the same command without --aot
    through `cli.main` in this one: the same JSON but for the
    timings."""
    import contextlib
    import io

    from multih_tpu_torch import cli

    out = {}
    for model in ("fundamental", "mixed"):
        res = {}
        argv = ["synth", "--model", model, "--json"]
        proc = subprocess.run(
            [sys.executable, "-m", "multih_tpu_torch.cli", *argv, "--aot"],
            cwd=ROOT, env=dict(os.environ, MULTIH_AOT=""),
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"cli synth --model {model} --aot: "
              f"{proc.stderr[-2000:]}")
        res["aot"] = proc.stdout
        aot_env = os.environ.pop("MULTIH_AOT", None)
        try:
            with contextlib.redirect_stdout(io.StringIO()) as buf:
                cli.main(argv)
        finally:
            if aot_env is not None:
                os.environ["MULTIH_AOT"] = aot_env
        res["plain"] = buf.getvalue()
        for label, stdout in res.items():
            res[label] = json.loads(stdout.strip().splitlines()[-1])
        diff = [k for k in res["plain"] if not k.startswith("time_")
                and res["aot"].get(k) != res["plain"][k]]
        check(not diff and res["aot"].keys() == res["plain"].keys(),
              f"cli synth --model {model} --aot differs from the plain run "
              f"in {diff}")
        print(f"cli synth --model {model} --json: --aot in a process equal "
              f"to the plain run but the timings")
        out[model] = dict(equal=True)
    return out


def _aot_rebuild() -> dict:
    """A copy of the library under a temporary cache root, truncated:
    _build.open_library rebuilds it once, with a warning, and the rebuilt
    library answers."""
    import ctypes
    import logging
    import shutil
    import tempfile

    from multih_tpu_torch.ops.kernels import _build

    root = tempfile.mkdtemp(prefix="aot_rebuild_",
                            dir=os.path.join(ROOT, "build"))
    try:
        src = _build.library_path()
        dst = _build.library_path(root)
        dst.parent.mkdir(parents=True)
        shutil.copy2(src, dst)
        with open(dst, "r+b") as fh:
            fh.truncate(4096)  # dlopen would map it and fault past 4096
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        _build.log.addHandler(handler)
        try:
            lib, path, _, rebuilt = _build.open_library(root)
        finally:
            _build.log.removeHandler(handler)
        buf = (ctypes.c_int * 3)()
        rc = lib.multih_inlier_counts_limits(buf)
        warned = [r.getMessage() for r in records
                  if r.levelno >= logging.WARNING]
        print(f"library truncated to 4096 bytes under a temporary cache "
              f"root: rebuilt {rebuilt}, warning "
              f"{warned[0][:160] if warned else None!r}, limits rc {rc} "
              f"{list(buf)}")
        check(rebuilt and path == dst and warned and rc == 0
              and os.path.getsize(dst) > 4096,
              "a truncated library was not rebuilt once, with a warning")
        return dict(rebuilt=rebuilt)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_aot(dev):
    """Phase 14: utils/aot.cached_fit and cached_fit_mixed on each of
    _aot_cases' cells. On each: the eager fit makes no synchronizing
    call; eager equals eager and the first call (warm-up, capture,
    replay) equals the eager fit given equal generator states, every
    leaf bit for bit and the generator's final state; a replay on a
    second seed equals its eager twin and differs from the first (where
    eager does not equal eager, the replays are held to the mixed
    goldens' contract instead, the generator's state still exact); the
    replay launches every kernel of the path, as many times as the eager
    fit, and none of `forbid` (the wrappers' counts during the capture
    and around an eager fit, and on the profiled cells the profiler's
    device events of a replay). Then the CLI's cold start with and
    without --aot, the CLI's F and mixed synth with and without --aot,
    and the rebuild of a truncated library."""
    import torch

    from multih_tpu_torch.utils import data, evaluation

    print("== 14. the fits' kinds captured as CUDA graphs (utils/aot.py)")
    out, launches = {}, {}
    for c in _aot_cases(dev):
        label, cfg, kind, pts, extra = (c["label"], c["cfg"], c["kind"],
                                        c["pts"], c["extra"])
        maker, expect = c["maker"], c["expect"]

        def run(fn, seed):
            g = torch.Generator(device=dev).manual_seed(seed)
            res = fn(*pts, g, *extra)
            torch.cuda.synchronize()
            return res, g.get_state()

        if not out:  # the detector sees a host read
            probe = _sync_sites(lambda: torch.zeros(1, device=dev).item())
            check(probe, "the sync debug mode saw no .item()")
            print(f"sync debug mode on .item(): {probe}")
        run(maker, 0)  # first uses (the F model's constants on the card)
        sites = _sync_sites(lambda: run(maker, 0))
        check(not sites, f"{label}: synchronizing calls in the eager fit: "
              f"{sites}")
        (e0, s0), eager_launches = count_launches(
            f"eager {label}", expect, lambda: run(maker, 0), quiet=True)
        e0b, s0b = run(maker, 0)
        deterministic = not _fit_diff(e0, e0b)
        check(torch.equal(s0, s0b), f"{label}: eager twice, two generator "
              f"states")
        if not deterministic:
            print(f"aot {label}: eager differs from eager in "
                  f"{_fit_diff(e0, e0b)}; the replays are held to the "
                  f"mixed goldens' contract")
            check(c["golden"], f"{label}: eager differs from eager in "
                  f"{_fit_diff(e0, e0b)}")
        fn = c["cached"](dev)
        (r0, g0), launches[f"aot {label}"] = count_launches(
            f"aot {label} (warm-up, capture, replay)", expect,
            lambda: run(fn, 0), quiet=True)
        captured = fn.launches
        per_replay = {k: v for k, v in captured.items() if v}
        check(torch.equal(g0, s0), f"{label}: the replay leaves the "
              f"generator in another state than the eager fit")
        r1, g1 = run(fn, 1)
        e1, s1 = run(maker, 1)
        check(torch.equal(g1, s1), f"{label}: the seed-1 replay leaves the "
              f"generator in another state than its eager twin")
        check(_fit_diff(r0, r1), f"{label}: two seeds, one result")
        row = dict(kind=kind, max_points=cfg.max_points,
                   launches_per_replay=per_replay,
                   eager_deterministic=deterministic)
        if deterministic:
            for a, b, what in ((r0, e0, "the replay"),
                               (r1, e1, "the seed-1 replay")):
                diff = _fit_diff(a, b)
                check(not diff, f"{label}: {what} differs from its eager "
                      f"twin in {diff}")
        else:
            row["contract"] = _mixed_contract([r0, r1], c["golden"])
        # the capture counts the kernels a device trace names; the
        # refit's calls (its K3 launches among them) stay on its wrapper
        eager_fit = {k: v for k, v in eager_launches.items()
                     if v and k in captured}
        check(per_replay == eager_fit, f"{label}: launches a replay "
              f"{per_replay}, an eager fit {eager_fit}")
        for k in expect:
            check(captured[k] > 0, f"{label}: {k} not in the graph")
        for k in c["forbid"]:
            check(captured[k] == 0, f"{label}: {k} in the graph")
        res0 = r0[0] if kind == "fit_adaptive" else r0
        row["models"] = int(res0.active.sum())
        if label.endswith("BASELINE 2"):
            cs, _ = data.synthetic_scene(1000, 2, 0.0, 0.0)
            err = evaluation.misclassification_error(
                res0.labels.cpu().numpy()[:1000], cs.gt_labels,
                cfg.max_labels)
            row["misclassification"] = err
            check(err == 0.0 and row["models"] == 2,
                  f"{label}: not recovered exactly from the replay "
                  f"({row['models']} planes, {err}%)")
        if c["profiled"]:
            # the profiler's kernels of one replay (a profile of the eager
            # motion or mixed fit, ~60k device events and as many host
            # ops, takes half a minute to read), where it came back
            row["profiler_per_replay"] = _replay_kernels(
                lambda: fn(*pts, torch.Generator(device=dev).manual_seed(5),
                           *extra))
            k1 = dict(per_replay)  # the profiler sees K1's kinds as one
            if k1.get("inlier_counts_f"):
                k1["inlier_counts"] = (k1.get("inlier_counts", 0)
                                       + k1.pop("inlier_counts_f"))
            check(row["profiler_per_replay"] in (None, k1),
                  f"{label}: the profiler saw "
                  f"{row['profiler_per_replay']} in a replay, the capture "
                  f"{k1}")
        out[label] = row
        same = ("replay = eager bit for bit on seeds 0 and 1 (and the "
                "generator's state)" if deterministic else
                f"eager != eager; replays held to the contract "
                f"{row['contract']}")
        print(f"aot {label}: {same}; launches a replay {per_replay} "
              f"(= an eager fit's); models {row['models']}"
              + (f"; the profiler's kernels a replay "
                 f"{row['profiler_per_replay']}" if c["profiled"] else ""))
    out["cold_start"] = _aot_cold_starts()
    out["cli_models"] = _aot_cli_models()
    out["rebuild"] = _aot_rebuild()
    return out, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import multih_tpu_torch  # noqa: F401  (sets the TF32 flags)

    dev = torch.device("cuda")
    phase_env()
    phase_build()
    kernels = phase_kernels(dev)
    launches = phase_fits(dev)
    (stress, launches["stress"], launches["side_stress"],
     launches["fused_front_stress"]) = phase_stress(dev)
    launches["motion"] = phase_motion(dev)
    adaptive, launches["adaptive"] = phase_adaptive(dev)
    stream, launches["stream_run"] = phase_stream(dev)
    mixed, launches["mixed"], launches["mixed_gather"] = phase_mixed(dev)
    surfaces, surface_launches, batch_res = phase_surfaces(dev)
    launches.update(surface_launches)
    mesh_out, mesh_launches = phase_mesh(dev, batch_res)
    launches.update(mesh_launches)
    pt_out, pt_launches = phase_pt(dev)
    launches.update(pt_launches)
    dryrun_out, dryrun_launches = phase_dryrun()
    launches.update(dryrun_launches)
    aot_out, aot_launches = phase_aot(dev)
    launches.update(aot_launches)
    rows = [dict(name=name, max_abs_err=k["max_abs_err"],
                 launches=sum(p.get(name, 0) for p in launches.values()),
                 launches_by_path={p: c.get(name, 0)
                                   for p, c in launches.items()},
                 shapes=k["shapes"]) for name, k in kernels.items()]
    print(json.dumps({"kernels": rows, "stress": stress,
                      "adaptive": adaptive, "stream": stream,
                      "mixed": mixed, "surfaces": surfaces,
                      "mesh": mesh_out, "pt": pt_out,
                      "dryrun": dryrun_out, "aot": aot_out}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
