#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the Multi-H fit on one GPU: the
homography fit and the fundamental (multi-motion) fit.

Run from the repository root on a host with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns of
                                     # the N=512, stress and motion fits

Phases, each raising on failure:
  1. environment: torch / CUDA / nvcc / triton, the card's name and power
     limit, TF32 off;
  2. build: nvcc compiles multih_tpu_torch/csrc/*.cu, one process per
     source (build seconds and the ptxas register / spill report);
  3. kernel parity: every kernel against its plain PyTorch version on the
     card at the main paths' shapes (K1 also at its epipolar kinds on the
     motion fit's verify shape, K3 also on the F normal matrices of a
     real refit in a motion fit), with kernel, plain and (where one
     PyTorch call computes the same function) library times, medians of
     CUDA-event timings, beside each kernel's bound: the larger of its
     bytes (inputs read once, outputs written once) at 3.35 TB/s and its
     operations at 67 TFLOP/s fp32, counted from this run's inputs;
  4. the fit end to end, each path with the launch counts set to 0 just
     before it and read just after: the side config MultiHConfig(
     knn_window=False, knn_approx=False) on BASELINE config 2 (K1-K3);
     then the default config MultiHConfig() on BASELINE config 2 (exact
     recovery) and three golden scenes (K1-K5), the card fit against the
     CPU fit, and the warm fit latency at N=512;
  5. the stress fit at bench.py::_stress_cfg(10240, 102400,
     n_candidates=256, max_labels=16)'s settings (window sampling, the
     windowed graph; 10k points, 70% outliers, 8 planes), with all six
     kernels launched; then the same scene once at the side config
     (row-blocked exact graph past N=4096, band with far edges; K1-K3);
  6. the fundamental-model fit: the motion suite's config
     MultiHConfig(model="fundamental", residual="sampson",
     n_hypotheses=2048, max_points=512) on fm2_b and fm4_a, 3 keys each,
     against the motion goldens (motion count exact on every key, mean
     misclassification within 2.0 pp), with the launches of every fit
     (K1 at f_sampson, K3, K4, K5; no K2, no K7), and the warm fit
     latency on fm4_a.
Then one JSON line of per-kernel results, the card line, and the last
line {"ok": true, "device": {...}}. Without a CUDA device, or outside
the repository, it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_SCENES = (("easy2_a", 512), ("med3_a", 512), ("hard5_a", 1024))
MOTION_SCENES = ("fm2_b", "fm4_a")
KERNELS = {
    "inlier_counts": dict(
        source="multih_tpu_torch/csrc/residual_kernel.cu",
        replaces="multih_tpu/ops/kernels/residual_kernel.py:242"),
    # K1's epipolar kinds: the same kernel and launch, an `f_` kind
    "inlier_counts_f": dict(
        source="multih_tpu_torch/csrc/residual_kernel.cu",
        replaces="multih_tpu/ops/kernels/residual_kernel.py:142"),
    "dlt_4pt": dict(
        source="multih_tpu_torch/csrc/dlt_kernel.cu",
        replaces="multih_tpu/ops/kernels/dlt_kernel.py:138"),
    "eig9_smallest": dict(
        source="multih_tpu_torch/csrc/eig_kernel.cu",
        replaces="multih_tpu/ops/kernels/eig_kernel.py:118"),
    "mean_field_fused": dict(
        source="multih_tpu_torch/csrc/mrf_kernel.cu",
        replaces="multih_tpu/ops/kernels/mrf_kernel.py:118"),
    "icm_fused": dict(
        source="multih_tpu_torch/csrc/mrf_kernel.cu",
        replaces="multih_tpu/ops/kernels/mrf_kernel.py:408"),
    "window_gather": dict(
        source="multih_tpu_torch/csrc/gather_kernel.cu",
        replaces="multih_tpu/ops/kernels/gather_kernel.py:94"),
}
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s, fp32
# non-tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12
# operations per (hypothesis, point) pair of the count kernel, counted
# from the residual formulas of csrc/residual_kernel.cu (mul, add, div,
# max, compare each one); per 4-point DLT solve and per 9x9 eigensolve
# from the notes of csrc/dlt_kernel.cu and csrc/eig_kernel.cu
COUNT_OPS = {"symmetric": 40, "transfer": 20, "sampson": 52,
             "f_symmetric": 39, "f_transfer": 25, "f_sampson": 37}
DLT_OPS = 1500
EIG_OPS = 13000


def sh(cmd: list[str]) -> str:
    """stdout of a short command (stderr appended on failure)."""
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    return (proc.stdout + ("" if proc.returncode == 0 else proc.stderr)).strip()


def card_line() -> str:
    return sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, one CUDA-event pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps: int) -> list[float]:
    """Host-clock ms of fn() ending in a device synchronize."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take, the
    larger of the bytes at the HBM rate and the operations at the fp32
    rate."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    t0 = time.perf_counter()
    _build.load()
    wall = time.perf_counter() - t0
    seconds, log, path = _build.build_report()
    print(f"library {os.path.relpath(path, ROOT)}; nvcc {seconds:.2f} s, "
          f"load {wall:.2f} s")
    for line in log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            print("  ptxas:", line.strip().removeprefix("ptxas info    : "))


def _scene_points(n_points, n_pad, seed, device):
    import torch

    from multih_tpu_torch import pad_points
    from multih_tpu_torch.utils import data

    cs, _ = data.synthetic_scene(n_points, 8, 0.7, 0.5, seed=seed)
    x1, x2, valid = pad_points(cs.x1, cs.x2, None, n_pad)
    return [torch.from_numpy(a).to(device) for a in (x1, x2, valid)]


def _quads(rng, s):
    """Uniform quads and a noisy affine image (the JAX DLT test's recipe),
    one repeated-point degenerate quad."""
    p1 = rng.uniform(0, 640, (s, 4, 2)).astype(np.float32)
    p2 = (p1 * 1.1 + rng.normal(0, 2.0, (s, 4, 2))).astype(np.float32)
    p1[5, 1] = p1[5, 0]
    p2[5, 1] = p2[5, 0]
    return p1, p2


def dlt_parity(got, packed):
    """Hold DLT kernel results to the plain version: 5e-4 max-abs (the
    JAX kernel's tolerance) on the non-degenerate quads whose float32
    solve is well conditioned, i.e. where the plain float32 solve is
    within 1e-4 of the float64 one. On the ill-conditioned rest (~0.2%
    of this recipe's quads) no float32 solver holds 5e-4: the plain
    version itself is up to 2.1e-3 from float64 there (measured on the
    CPU over 51200 quads), so those are reported, kernel and plain each
    against float64, not held. Returns (max-abs error on the
    well-conditioned quads, ill-conditioned count, kernel and plain
    max-abs error vs float64 on them)."""
    import torch

    from multih_tpu_torch.ops import geometry
    from multih_tpu_torch.ops.kernels import dlt_kernel

    ref = dlt_kernel.homography_4pt_packed_reference(packed)
    ref64 = dlt_kernel.homography_4pt_packed_reference(packed.double())
    p = packed.reshape(2, 4, 2, -1)  # image, point, coord, quad
    degen = (geometry.quad_degenerate_t(p[0, :, 0], p[0, :, 1], 1e-4)
             | geometry.quad_degenerate_t(p[1, :, 0], p[1, :, 1], 1e-4))
    e_plain = (ref.double() - ref64).abs().amax((1, 2))
    e_kern = (got.double() - ref64).abs().amax((1, 2))
    well = ~degen & (e_plain < 1e-4)
    ill = ~degen & ~well
    err = float((got - ref).abs().amax((1, 2))[well].max())
    check(err < 5e-4, f"DLT kernel: max abs err {err} vs the plain version")
    zero = torch.zeros(1, dtype=e_kern.dtype, device=e_kern.device)
    return (err, int(ill.sum()), float(torch.cat([e_kern[ill], zero]).max()),
            float(torch.cat([e_plain[ill], zero]).max()))


def _normal_matrices(rng, c):
    """(C, 9, 9) DLT normal matrices of noisy 12-point samples."""
    import torch

    from multih_tpu_torch.ops import geometry

    x1 = rng.uniform(-1, 1, (c, 12, 2))
    H = np.eye(3) + rng.normal(0, 0.1, (c, 3, 3))
    pr = np.concatenate([x1, np.ones((c, 12, 1))], 2) @ H.transpose(0, 2, 1)
    x2 = pr[..., :2] / pr[..., 2:3] + rng.normal(0, 0.01, (c, 12, 2))
    return geometry.dlt_normal_matrix(
        torch.from_numpy(x1.astype(np.float32)),
        torch.from_numpy(x2.astype(np.float32)))


def _motion_points(name, n_pad, device):
    import torch

    from multih_tpu_torch import pad_points
    from multih_tpu_torch.utils import data

    cs = data.motion_suite_scene(name)
    return [torch.from_numpy(a).to(device)
            for a in pad_points(cs.x1, cs.x2, None, n_pad)]


def _f_refit_normal_matrices(dev):
    """(256, 9, 9) normal matrices of a real F refit on the card: the
    first C=256 batch that one motion fit on fm4_a hands the eigensolve
    (the LO refine of the 256 top-counted hypotheses), taken as it is
    handed over."""
    from multih_tpu_torch import make_fit_tau
    from multih_tpu_torch.ops import geometry

    seen = []
    solve = geometry.smallest_eigvecs

    def capture(atas, *args):
        if atas.shape[0] == 256 and not seen:
            seen.append(atas.clone())
        return solve(atas, *args)

    geometry.smallest_eigvecs = capture
    try:
        make_fit_tau(motion_cfg(512))(*_motion_points("fm4_a", 512, dev),
                                      _cpu_draws(0), 3.0)
    finally:
        geometry.smallest_eigvecs = solve
    check(len(seen) == 1, "the motion fit made no C=256 refit")
    return seen[0].contiguous()


def eig_parity(atas, got, ref):
    """Hold eigensolver results on F normal matrices. Their smallest
    eigenvalue gap is down to ~6e-5 of the largest, so float32 fixes the
    smallest eigenvector only to the first-order floor eps32 * lam_max /
    (lam_2 - lam_1), up to ~2e-3: the kernel must be within twice that
    floor of float64 eigh on every matrix (the plain Jacobi and float32
    eigh reach about half of it, measured on the CPU), and within 1e-4
    of the plain version where the floor is below 1e-5. Returns (max-abs
    error vs the plain version on those, their count, the largest
    error / floor of kernel and plain, the max-abs error vs the plain
    version over all)."""
    import torch

    ev, vec = torch.linalg.eigh(atas.double())
    v64 = vec[..., 0]
    floor = torch.finfo(torch.float32).eps * ev[:, -1] / (ev[:, 1] - ev[:, 0])

    def err(v, to):
        sign = torch.sign((v.double() * to).sum(1, keepdim=True))
        return (v.double() * sign - to).abs().amax(1)

    ratio_k = float((err(got, v64) / floor).nan_to_num(0.0).max())
    ratio_p = float((err(ref, v64) / floor).nan_to_num(0.0).max())
    check(ratio_k <= 2.0, f"eig kernel on F normal matrices: {ratio_k:.3g} "
          f"times the float32 floor from float64 eigh")
    well = floor < 1e-5
    check(int(well.sum()) > 0, "no well-conditioned F normal matrix")
    e_all = err(got, ref.double())
    e_well = float(e_all[well].max())
    check(e_well <= 1e-4, f"eig kernel on well-conditioned F normal "
          f"matrices: max abs err {e_well} vs the plain version")
    return e_well, int(well.sum()), ratio_k, ratio_p, float(e_all.max())


def phase_kernels(dev):
    import torch

    from multih_tpu_torch.ops import fmodel, geometry
    from multih_tpu_torch.ops.kernels import dlt_kernel, eig_kernel
    from multih_tpu_torch.ops.kernels import residual_kernel as rk

    print("== 3. kernel parity and timing (kernel vs plain vs library; "
          "bound)")
    rng = np.random.default_rng(0)
    results = {}

    def record(name, shape, err, k_ms, p_ms, n_bytes, n_ops, lib_ms=None):
        b_ms, b_by = bound(n_bytes, n_ops)
        lib = "none" if lib_ms is None else f"{lib_ms:9.4f} ms"
        print(f"{name:16s} {shape:34s} max_abs_err {err:<10.4g} "
              f"kernel {k_ms:9.4f} ms  plain {p_ms:9.4f} ms  library {lib}"
              f"  bound {b_ms:.5f} ms ({b_by})")
        r = results.setdefault(name, dict(max_abs_err=0.0, shapes=[]))
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        r["shapes"].append(dict(shape=shape, ms=k_ms, plain_ms=p_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=lib_ms))
        return r["shapes"][-1]

    # K1: hypotheses solved from scene quads, at the claim / verify sweep
    # (2051 x 512, symmetric) and the stress ranking sweep (102400 x 1280,
    # transfer) shapes; sampson checked at the small shape
    x1, x2, valid = _scene_points(10000, 10240, 42, dev)
    thr = torch.full((), 9.0, device=dev)
    for s, n, kind in ((2051, 512, "symmetric"), (2051, 512, "sampson"),
                       (102400, 1280, "transfer")):
        idx = torch.from_numpy(rng.integers(0, 10000, (s, 4))).to(dev)
        Hs = geometry.homography_4pt_batch_qr(x1[idx], x2[idx]).contiguous()
        px, py, pv = x1[:n].contiguous(), x2[:n].contiguous(), valid[:n]
        got = rk.inlier_counts_padded(Hs, px, py, pv, thr, kind=kind)
        ref = rk.inlier_counts_reference(Hs, px, py, pv, thr, kind)
        d = (got - ref).abs()
        check(float(ref.max()) > 0, "no inliers in the count check")
        check(float(d.max()) <= 2.0 and float(d.mean()) < 0.5,
              f"count kernel {kind} {s}x{n}: max {float(d.max())} "
              f"mean {float(d.mean())}")
        record("inlier_counts", f"{s}x{n} {kind}", float(d.max()),
               cuda_ms(lambda: rk.inlier_counts_padded(Hs, px, py, pv, thr,
                                                       kind=kind)),
               cuda_ms(lambda: rk.inlier_counts_reference(Hs, px, py, pv,
                                                          thr, kind),
                       reps=5),
               4 * (s * 9 + 5 * n + s), s * n * COUNT_OPS[kind])

    # K1's epipolar kinds at the motion fit's verify shape (2048
    # hypotheses + 3 claims x 512 points), F's solved from 8-point
    # samples of the fm4_a scene
    x1, x2, valid = _motion_points("fm4_a", 512, dev)
    n_valid = int(valid.sum())
    for kind in ("f_sampson", "f_symmetric", "f_transfer"):
        s = 2051
        idx = torch.from_numpy(rng.integers(0, n_valid, (s, 8))).to(dev)
        Fs = fmodel.fundamental_8pt_batch_qr(x1[idx], x2[idx]).contiguous()
        got = rk.inlier_counts_padded(Fs, x1, x2, valid, thr, kind=kind)
        ref = rk.inlier_counts_reference(Fs, x1, x2, valid, thr, kind)
        d = (got - ref).abs()
        check(float(ref.max()) > 0, "no inliers in the F count check")
        check(float(d.max()) <= 2.0 and float(d.mean()) < 0.5,
              f"count kernel {kind} {s}x512: max {float(d.max())} "
              f"mean {float(d.mean())}")
        record("inlier_counts_f", f"{s}x512 {kind}", float(d.max()),
               cuda_ms(lambda: rk.inlier_counts_padded(Fs, x1, x2, valid,
                                                       thr, kind=kind)),
               cuda_ms(lambda: rk.inlier_counts_reference(Fs, x1, x2, valid,
                                                          thr, kind),
                       reps=5),
               4 * (s * 9 + 5 * 512 + s), s * 512 * COUNT_OPS[kind])

    # K2: minimal solves per progressive round, default and stress
    for s in (512, 51200):
        p1, p2 = _quads(rng, s)
        packed = torch.from_numpy(np.concatenate(
            [p1.reshape(-1, 8).T, p2.reshape(-1, 8).T])).to(dev).contiguous()
        got = dlt_kernel.homography_4pt_packed(packed)
        check(bool(torch.isfinite(got).all()), "DLT kernel: non-finite H")
        err, n_ill, e_k, e_p = dlt_parity(got, packed)
        print(f"  dlt S={s}: {n_ill} ill-conditioned quads, max abs err vs "
              f"float64 there: kernel {e_k:.3g}, plain {e_p:.3g}")
        record("dlt_4pt", f"S={s}", err,
               cuda_ms(lambda: dlt_kernel.homography_4pt_packed(packed)),
               cuda_ms(lambda: dlt_kernel.homography_4pt_packed_reference(
                   packed), reps=5),
               4 * 25 * s, DLT_OPS * s)

    # K3: the LO-refine batch (n_candidates)
    for c in (256,):
        atas = _normal_matrices(rng, c).to(dev).contiguous()
        got = eig_kernel.smallest_eigvec_9x9_batch(atas)
        ref = eig_kernel.smallest_eigvec_9x9_batch_reference(atas)
        sign = torch.sign((got * ref).sum(1, keepdim=True))
        err = float((got * sign - ref).abs().max())
        check(err <= 1e-4, f"eig kernel C={c}: max abs err {err}")
        record("eig9_smallest", f"C={c}", err,
               cuda_ms(lambda: eig_kernel.smallest_eigvec_9x9_batch(atas)),
               cuda_ms(lambda: eig_kernel.smallest_eigvec_9x9_batch_reference(
                   atas), reps=5),
               4 * 90 * c, EIG_OPS * c,
               lib_ms=cuda_ms(lambda: torch.linalg.eigh(atas)))
    # K3 on F normal matrices: the 256 of a real F refit on fm4_a (their
    # smallest eigenvalue gaps differ from the homography ones')
    atas = _f_refit_normal_matrices(dev)
    got = eig_kernel.smallest_eigvec_9x9_batch(atas)
    ref = eig_kernel.smallest_eigvec_9x9_batch_reference(atas)
    err, n_well, ratio_k, ratio_p, err_all = eig_parity(atas, got, ref)
    print(f"  eig on F normal matrices: {n_well} of 256 with a float32 "
          f"floor below 1e-5; error / floor vs float64 eigh at most: kernel "
          f"{ratio_k:.3g}, plain {ratio_p:.3g}; max abs err vs the plain "
          f"version over all 256 {err_all:.3g}")
    record("eig9_smallest", "C=256 F normal matrices", err,
           cuda_ms(lambda: eig_kernel.smallest_eigvec_9x9_batch(atas)),
           cuda_ms(lambda: eig_kernel.smallest_eigvec_9x9_batch_reference(
               atas), reps=5),
           4 * 90 * 256, EIG_OPS * 256,
           lib_ms=cuda_ms(lambda: torch.linalg.eigh(atas)))

    mrf_kernels(rng, dev, record)
    gather_kernels(rng, dev, record)
    torch.cuda.synchronize()
    return results


def _windowed_problem(dev, n_points, n_pad, block, seed=42):
    """Morton-sorted scene points with their windowed k-NN graph and its
    far-free band, as the fit builds them."""
    from multih_tpu_torch.models import labeling, pipeline

    x1, x2, valid = _scene_points(n_points, n_pad, seed, dev)
    perm = pipeline.morton_order(x1, valid)
    x1, x2, valid = x1[perm], x2[perm], valid[perm]
    nbr_idx, nbr_w = labeling.knn_graph_windowed(x1, valid, 6, block)
    adj = labeling.build_banded_adjacency(nbr_idx, nbr_w, block,
                                          far_capacity=0)
    check(int(adj.n_dropped) == 0, "windowed graph with out-of-band edges")
    return x1, x2, valid, nbr_idx, adj


def mrf_kernels(rng, dev, record):
    """K4 and K5 at the default shape (L=17, N=512, B=256, 6 mean-field
    sweeps, 2 ICM starts x 2 iterations) and the stress shape (L=17,
    N=10240, B=128, 4 sweeps, 2 starts x 1 iteration)."""
    import torch

    from multih_tpu_torch.ops.kernels import mrf_kernel as mk

    l, sw = 17, 0.1
    for n_points, n, block, sweeps, icm_it in ((500, 512, 256, 6, 2),
                                               (10000, 10240, 128, 4, 1)):
        _, _, valid, _, adj = _windowed_problem(dev, n_points, n, block)
        dct = torch.from_numpy(rng.uniform(0, 2.0, (l, n)).astype(
            np.float32)).to(dev) * valid[None, :]
        q0 = torch.softmax(-dct / 2.0, dim=0).contiguous()
        base = (dct + sw * adj.deg.T).contiguous()
        band = adj.band
        inv_t = torch.from_numpy((1.0 / np.geomspace(2.0, 0.25, sweeps))
                                 .astype(np.float32)).to(dev)
        nnz = int((band != 0).sum())
        nb = n // block
        band_bytes = 4 * nb * block * 3 * block
        shape = f"L={l} N={n} B={block}"

        got = mk.mean_field_fused(q0, base, band, inv_t, sw)
        ref = mk.mean_field_fused_reference(q0, base, band, inv_t, sw)
        err = float((got - ref).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= 1e-5,
              f"mean-field kernel {shape}: max abs err {err}")
        row = record("mean_field_fused", f"{shape} sweeps={sweeps}", err,
                     cuda_ms(lambda: mk.mean_field_fused(q0, base, band,
                                                         inv_t, sw)),
                     cuda_ms(lambda: mk.mean_field_fused_reference(
                         q0, base, band, inv_t, sw), reps=5),
                     band_bytes + 4 * (3 * l * n + sweeps),
                     sweeps * (2 * nnz * l + 8 * l * n))
        # one launch per sweep: the time of one more sweep, launch
        # included, from a 1-sweep call against the S-sweep one
        one = cuda_ms(lambda: mk.mean_field_fused(q0, base, band,
                                                  inv_t[:1], sw))
        row["one_sweep_ms"] = one
        row["per_sweep_ms"] = (row["ms"] - one) / (sweeps - 1)
        print(f"  mean-field {shape}: 1 sweep {one:.4f} ms, each further "
              f"sweep {row['per_sweep_ms']:.4f} ms; band non-zeros {nnz} "
              f"of {nb * block * 3 * block} ({100.0 * nnz / (nb * block * 3 * block):.2f}%)")

        starts = torch.stack([
            torch.argmin(dct, dim=0),
            torch.from_numpy(rng.integers(0, l, n)).to(dev),
        ]).to(torch.int32).contiguous()
        got = mk.icm_fused(starts, base, band, icm_it, sw)
        ref = mk.icm_fused_reference(starts, base, band, icm_it, sw)
        err = float((got - ref).abs().max())
        check(err == 0, f"ICM kernel {shape}: labels differ ({err})")
        check(bool((got != starts).any()), "ICM kernel moved no label")
        s = starts.shape[0]
        record("icm_fused", f"{shape} S={s} iterations={icm_it}", err,
               cuda_ms(lambda: mk.icm_fused(starts, base, band, icm_it, sw)),
               cuda_ms(lambda: mk.icm_fused_reference(starts, base, band,
                                                      icm_it, sw), reps=5),
               band_bytes + 4 * (2 * s * n + l * n),
               icm_it * s * (nnz * l + 3 * l * n))


def gather_kernels(rng, dev, record):
    """K7 at the stress shapes windowed_quadruples gives it (80 windows of
    3B=384 rows): "rank" mode over the whole C=15 source with T=1600
    selections per window, "index" mode over its first 8 channels with
    T=1280; picks past the range and ranks past each window's count
    included. The library call for "index" mode is one torch.gather of
    the same rows (without the zeroing of out-of-range picks)."""
    import torch

    from multih_tpu_torch.ops import sampling
    from multih_tpu_torch.ops.kernels import gather_kernel as gk

    block = 128
    x1, x2, valid, nbr_idx, _ = _windowed_problem(dev, 10000, 10240, block)
    avail = valid.clone()
    avail[:3000] = 0.0  # a claimed region: exhausted windows
    win_all = sampling.window_source(x1, x2, avail, nbr_idx, block)
    nb, rows, _ = win_all.shape
    m_max = int(win_all[:, -1, gk.CUM_CH].max())
    for mode, t, hi in (("index", 1280, rows + 2), ("rank", 1600, m_max + 8)):
        win = (win_all[:, :, :8] if mode == "index" else win_all).contiguous()
        c = win.shape[2]
        sel = torch.from_numpy(rng.integers(-2, hi, (nb, t)).astype(
            np.int32)).to(dev)
        got = gk.window_gather(win, sel, mode)
        ref = gk.window_gather_reference(win, sel, mode)
        check(torch.equal(got, ref), f"window gather {mode}: not exact")
        lib_ms = None
        if mode == "index":
            idx = sel.clamp(0, rows - 1).long()[:, :, None].expand(-1, -1, c)
            lib_ms = cuda_ms(lambda: torch.gather(win, 1, idx))
        record("window_gather", f"{mode} nb={nb} 3B={rows} C={c} T={t}",
               0.0, cuda_ms(lambda: gk.window_gather(win, sel, mode)),
               cuda_ms(lambda: gk.window_gather_reference(win, sel, mode),
                       reps=5),
               4 * (nb * rows * c + nb * t + nb * c * t), 0, lib_ms=lib_ms)


def _cpu_draws(seed):
    """Draws from a CPU generator: the same minimal samples for a CPU fit
    and a card fit."""
    import torch

    from multih_tpu_torch.ops.sampling import TorchDraws

    return TorchDraws(torch.Generator().manual_seed(seed))


def _slice_cfg(**kw):
    """The side config the port ran first (exact k-NN, the general band
    with far edges, plain MRF sweeps)."""
    from multih_tpu_torch import MultiHConfig

    return MultiHConfig(knn_window=False, knn_approx=False, **kw)


def _to(dev, *arrays):
    import torch

    return [torch.from_numpy(np.asarray(a)).to(dev) for a in arrays]


def _wrappers():
    from multih_tpu_torch.ops.kernels import (dlt_kernel, eig_kernel,
                                              gather_kernel, mrf_kernel,
                                              residual_kernel)

    return {
        "inlier_counts": residual_kernel.inlier_counts,
        "dlt_4pt": dlt_kernel.homography_4pt_packed,
        "eig9_smallest": eig_kernel.smallest_eigvec_9x9_batch,
        "mean_field_fused": mrf_kernel.mean_field_fused,
        "icm_fused": mrf_kernel.icm_fused,
        "window_gather": gather_kernel.window_gather,
    }


def count_launches(label: str, expect, fn, quiet: bool = False):
    """Run fn() with every kernel's launch count set to 0 just before and
    read just after; fail unless each kernel in `expect` launched. K1's
    launches are split by residual kind: `inlier_counts` counts the
    homography kinds, `inlier_counts_f` the epipolar (f_) kinds."""
    import torch

    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    k1 = wrappers["inlier_counts"]
    k1.kind_launches = {}
    out = fn()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    f_kinds = {k: v for k, v in k1.kind_launches.items()
               if k.startswith("f_")}
    launches["inlier_counts_f"] = sum(f_kinds.values())
    launches["inlier_counts"] -= launches["inlier_counts_f"]
    if not quiet:
        print(f"kernel launches on the {label} path:", launches,
              "K1 by kind:", k1.kind_launches)
    for k in expect:
        check(launches[k] > 0, f"kernel {k} never launched on the {label} "
              f"path")
    return out, launches


def _baseline2(dev, cfg, gen):
    """BASELINE.json config 2: 1k noise-free correspondences, 2 planes,
    exact recovery."""
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import data, evaluation

    cs, _ = data.synthetic_scene(1000, 2, 0.0, 0.0)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 1024)
    res = mt.make_fit(cfg)(*_to(dev, x1, x2, valid), gen.manual_seed(0))
    check(res.labels.device.type == res.homographies.device.type
          == torch.device(dev).type, "results not on the card")
    err = evaluation.misclassification_error(res.labels.cpu().numpy(), gt,
                                             cfg.max_labels)
    return int(res.active.sum()), err


def phase_fits(dev):
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch import MultiHConfig
    from multih_tpu_torch.utils import data, evaluation

    print("== 4. the fit on the card: side config, then the default config")
    gen = torch.Generator(device=dev)
    k123 = ("inlier_counts", "dlt_4pt", "eig9_smallest")
    launches = {}

    (planes, err), launches["side"] = count_launches(
        "side-config", k123,
        lambda: _baseline2(dev, _slice_cfg(max_points=1024), gen))
    print(f"side config, BASELINE config 2: planes {planes}, "
          f"misclassification {err:.4f}%")
    check(err == 0.0 and planes == 2, "side config: BASELINE config 2 not "
          "recovered exactly")

    def default_path():
        planes, err = _baseline2(dev, MultiHConfig(max_points=1024), gen)
        print(f"default config, BASELINE config 2: planes {planes}, "
              f"misclassification {err:.4f}%")
        check(err == 0.0 and planes == 2,
              "BASELINE config 2 not recovered exactly")
        fits = {}
        for name, npad in GOLDEN_SCENES:
            g = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npz"))
            cs = data.suite_scene(name)
            cfg = MultiHConfig(max_points=npad)
            x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels,
                                              npad)
            args = _to(dev, x1, x2, valid)
            tau = float(g["inlier_threshold"])
            res = mt.make_fit_tau(cfg)(*args, gen.manual_seed(0), tau)
            lab = res.labels.cpu().numpy()[: cs.n_points]
            check(bool(torch.isfinite(res.homographies).all()),
                  "non-finite H")
            err = evaluation.misclassification_error(lab, cs.gt_labels,
                                                     cfg.max_labels)
            agree = 100.0 - evaluation.misclassification_error(
                lab, g["labels"], cfg.max_labels,
                gt_outlier=int(g["outlier_label"]))
            print(f"golden {name} (npad {npad}, tau {tau}): planes "
                  f"{int(res.active.sum())} (golden {int(g['n_planes'])}), "
                  f"misclassification {err:.3f}% (golden "
                  f"{float(g['misclassification']):.3f}%), agreement with "
                  f"the golden labels {agree:.2f}%")
            check(agree >= 97.0, f"{name}: agreement {agree:.2f}% < 97%")
            fits[name] = (cfg, args, tau)
        return fits

    golden_fits, launches["default"] = count_launches(
        "default-config", k123 + ("mean_field_fused", "icm_fused"),
        default_path)

    # the card fit against the port's CPU fit on the same samples (the
    # CPU runs the plain paths: eigh instead of the Jacobi kernel, the
    # plain sweeps' arithmetic instead of the fused kernels')
    cfg, args, tau = golden_fits["easy2_a"]
    f = mt.make_fit_tau(cfg)
    lab_gpu = f(*args, _cpu_draws(1), tau).labels.cpu().numpy()
    lab_cpu = f(*[a.cpu() for a in args], _cpu_draws(1), tau).labels.numpy()
    agree = 100.0 - evaluation.misclassification_error(
        lab_gpu, lab_cpu, cfg.max_labels, gt_outlier=cfg.max_labels)
    print(f"easy2_a card fit vs CPU fit, default config, same draws: label "
          f"agreement {agree:.2f}%")
    check(agree >= 97.0, "card fit disagrees with the CPU fit")

    # warm fit latency at N=512 (S=2048), host clock to synchronize: the
    # default config, and the side config on the same scene beside it
    lat = {}
    for label, fn in (("default", f),
                      ("side", mt.make_fit_tau(_slice_cfg(max_points=512)))):
        times = host_ms(lambda: fn(*args, gen, tau), reps=20)
        lat[label] = dict(median_ms=statistics.median(times),
                          min_ms=min(times), max_ms=max(times),
                          reps=len(times))
        print(f"warm fit latency easy2_a N=512, {label} config: median "
              f"{lat[label]['median_ms']:.2f} ms (min "
              f"{lat[label]['min_ms']:.2f}, max {lat[label]['max_ms']:.2f},"
              f" {len(times)} fits)")
    return launches, lat, lambda: _profile(
        "N=512 easy2_a, default config", lambda: f(*args, gen, tau))


STAGES = ("knn_graph", "banded_adjacency", "sampling_knn", "hypothesize",
          "verify", "lo_refine", "select", "pearl", "split_refine",
          "union_refit_merge", "f_refine_phases", "finalize")


def _profile(label: str, fn, reps: int = 5):
    """torch.profiler over `reps` warm calls of fn: device time by op and
    kernel, the device busy time (the table's 'Self CUDA time total': the
    self device time of the device events, without the record_function
    annotations, whose device ranges span their stage's wall time), and
    each stage's host time per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(f"== profile: {label}, {reps} fits")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    print(ka.table(sort_by="self_cuda_time_total", row_limit=20))
    busy = sum(e.self_device_time_total for e in ka
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))
    print(f"device busy {busy / reps / 1e3:.3f} ms/fit ({reps} fits)")
    for e in ka:
        if e.key in STAGES and e.cpu_time_total > 0:
            print(f"stage {e.key:17s} host {e.cpu_time_total / reps / 1e3:9.3f}"
                  f" ms/fit")


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


def phase_stress(dev):
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import data, evaluation

    print("== 5. the stress fit (bench.py _stress_cfg's settings)")
    cfg = stress_cfg()
    cs, _ = data.synthetic_scene(10000, 8, 0.7, 0.5, seed=42)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 10240)
    args = _to(dev, x1, x2, valid)
    f = mt.make_fit(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    res, launches = count_launches(
        "stress", tuple(k for k in KERNELS if k != "inlier_counts_f"),
        lambda: f(*args, gen))
    cold = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(res.homographies).all()), "non-finite H")
    lab = res.labels.cpu().numpy()
    check(lab.min() >= 0 and lab.max() <= cfg.max_labels, "labels range")
    err = evaluation.misclassification_error(lab, gt, cfg.max_labels)
    times = host_ms(lambda: f(*args, gen), reps=3)
    out = dict(planes=int(res.active.sum()), misclassification=err,
               n_far_dropped=int(res.n_far_dropped), first_fit_ms=cold,
               warm_ms=times)
    print(f"stress: planes {out['planes']} of 8, misclassification "
          f"{err:.3f}%, n_far_dropped {out['n_far_dropped']}, first fit "
          f"{cold:.1f} ms, warm fits {', '.join(f'{t:.1f}' for t in times)}"
          f" ms")
    check(out["planes"] == 8, f"stress: {out['planes']} planes of 8")
    check(out["n_far_dropped"] == 0, "stress: far edges dropped")

    # the same scene at the side config: the exact graph's row blocks
    # (N > 4096) and the band's far-edge list run only at this size
    side = dataclasses.replace(cfg, knn_window=False, knn_approx=False,
                               window_sampling=False)
    f_side = mt.make_fit(side)
    res, side_launches = count_launches(
        "side-config stress", ("inlier_counts", "dlt_4pt", "eig9_smallest"),
        lambda: f_side(*args, gen))
    check(bool(torch.isfinite(res.homographies).all()), "non-finite H")
    err = evaluation.misclassification_error(res.labels.cpu().numpy(), gt,
                                             cfg.max_labels)
    times = host_ms(lambda: f_side(*args, gen), reps=2)
    out["side"] = dict(planes=int(res.active.sum()), misclassification=err,
                       n_far_dropped=int(res.n_far_dropped), warm_ms=times)
    print(f"side-config stress: planes {out['side']['planes']} of 8, "
          f"misclassification {err:.3f}%, n_far_dropped "
          f"{out['side']['n_far_dropped']}, warm fits "
          f"{', '.join(f'{t:.1f}' for t in times)} ms")
    check(out["side"]["planes"] == 8,
          f"side-config stress: {out['side']['planes']} planes of 8")
    return (out, launches, side_launches,
            lambda: _profile("stress", lambda: f(*args, gen), reps=2))


def motion_cfg(npad: int):
    """The motion suite's config (tests/test_golden_parity.py:145-148)."""
    from multih_tpu_torch import MultiHConfig

    return MultiHConfig(max_points=npad, n_hypotheses=2048,
                        model="fundamental", residual="sampson")


def phase_motion(dev):
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import data, evaluation

    print("== 6. the fundamental (multi-motion) fit on the card")
    expect = ("inlier_counts_f", "eig9_smallest", "mean_field_fused",
              "icm_fused")
    cfg = motion_cfg(512)
    f = mt.make_fit_tau(cfg)
    per_fit, results, path = [], {}, {}

    for name in MOTION_SCENES:
        g = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npz"))
        cs = data.motion_suite_scene(name)
        args = _motion_points(name, 512, dev)
        tau = float(g["inlier_threshold"])
        counts, errs = [], []
        for k in range(3):
            # the CPU generator of key k, as tests/test_torch_motion.py
            res, fit_launches = count_launches(
                f"motion {name} key {k}", expect,
                lambda: f(*args, _cpu_draws(k), tau), quiet=True)
            check(fit_launches["inlier_counts"] == 0
                  and fit_launches["dlt_4pt"] == 0
                  and fit_launches["window_gather"] == 0,
                  f"motion fit launched a homography-path kernel: "
                  f"{fit_launches}")
            per_fit.append(fit_launches)
            for kname, c in fit_launches.items():
                path[kname] = path.get(kname, 0) + c
            check(bool(torch.isfinite(res.homographies).all()),
                  "non-finite F")
            lab = res.labels.cpu().numpy()[: cs.n_points]
            check(lab.min() >= 0 and lab.max() <= cfg.max_labels,
                  "labels range")
            counts.append(int(res.active.sum()))
            errs.append(evaluation.misclassification_error(
                lab, cs.gt_labels, cfg.max_labels))
        golden_err = float(g["misclassification"])
        golden_n = int(g["n_planes"])
        delta = float(np.mean(errs)) - golden_err
        results[name] = dict(counts=counts, misclassification=errs,
                             golden_misclassification=golden_err,
                             golden_motions=golden_n, delta=delta)
        print(f"motion {name} (tau {tau}): motions {counts} (golden "
              f"{golden_n}), misclassification {np.mean(errs):.3f}% "
              f"(golden {golden_err:.3f}%), delta {delta:+.3f} pp")
        check(counts == [golden_n] * 3, f"{name}: motion counts {counts}, "
              f"golden {golden_n}")
        check(abs(delta) <= 2.0, f"{name}: delta {delta:+.3f} pp > 2.0")
    print("kernel launches per motion fit:",
          [{k: v for k, v in c.items() if v} for c in per_fit])
    print("kernel launches on the motion path:", path)

    # warm fit latency, fm4_a, host clock to synchronize
    args = _motion_points("fm4_a", 512, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = host_ms(lambda: f(*args, gen, 3.0), reps=10)
    lat = dict(median_ms=statistics.median(times), min_ms=min(times),
               max_ms=max(times), reps=len(times))
    print(f"warm motion fit latency fm4_a N=512: median {lat['median_ms']:.2f}"
          f" ms (min {lat['min_ms']:.2f}, max {lat['max_ms']:.2f}, "
          f"{len(times)} fits)")
    out = dict(scenes=results, latency_fm4_a=lat, launches_per_fit=per_fit)
    return out, path, lambda: _profile(
        "N=512 fm4_a, motion config", lambda: f(*args, gen, 3.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the N=512, stress and motion fits")
    args = ap.parse_args(argv)

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
    launches, latency, profile_fit = phase_fits(dev)
    (stress, launches["stress"], launches["side_stress"],
     profile_stress) = phase_stress(dev)
    motion, launches["motion"], profile_motion = phase_motion(dev)
    if args.profile:
        profile_fit()
        profile_stress()
        profile_motion()

    rows = []
    for name, meta in KERNELS.items():
        main_shape = kernels[name]["shapes"][0]
        rows.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=sum(p[name] for p in launches.values()),
            max_abs_err=kernels[name]["max_abs_err"],
            ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"],
            launches_by_path={p: c[name] for p, c in launches.items()},
            shape=main_shape["shape"], shapes=kernels[name]["shapes"],
        ))
    print(json.dumps({"kernels": rows, "fit_latency_n512": latency,
                      "stress": stress, "motion": motion}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
