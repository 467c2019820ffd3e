#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the Multi-H fit on one GPU: the
homography fit (default and fused-front routes), the fundamental
(multi-motion) fit, the adaptive-threshold fit, the frame stream and the
mixed plane + motion fit.

Run from the repository root on a host with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns of
                                     # the N=512, stress, motion and
                                     # mixed fits

Phases, each raising on failure:
  1. environment: torch / CUDA / nvcc / triton, the card's name and power
     limit, TF32 off;
  2. build: nvcc compiles multih_tpu_torch/csrc/*.cu, one process per
     source (build seconds and the ptxas register / spill report);
  3. kernel parity: every kernel against its plain PyTorch version on the
     card at the main paths' shapes (K1 in both reciprocal modes, also
     past one shared-memory tile, on a split point axis, at its
     epipolar kinds on the motion fit's verify shape and at both kinds
     on the mixed stages' (2051 x 1024), with its CUDA launches a call:
     1; K2 from the sampler's (32, S) rows with degenerate and padded
     quads, ok exact, H's within 5e-4 of the plain version and 1e-6 of
     float64, 1 launch a call; K3 at the LO-refine batch C=256 and a
     PEARL batch C=16 and on the F normal matrices of a real refit in a
     motion fit and in the mixed polish (C=8), held to float64 eigh too;
     K6 at both homography kinds with the threshold a device tensor; the
     neighbour list bit-exact; K4, K5 and K6 on the list the fit builds,
     K4, K5 and the list also at the mixed stages' L=9, N=1024, with
     their CUDA launches a call counted by torch.profiler: 1, 1 and 2),
     with kernel, plain and
     (where one PyTorch call computes the same function) library times
     beside each kernel's bound: the larger of its bytes (inputs read once, outputs
     written once) at 3.35 TB/s and its operations at 67 TFLOP/s fp32
     (fp64 at 34, K1's reciprocals at the MUFU rate), counted from this
     run's inputs. Two times for the kernel and the
     library call: "call ms", the median of CUDA-event pairs around one
     call (the wrapper's host work included: the card is idle when the
     first event fires), and "device ms", the device time of the call's
     kernels alone from torch.profiler over 50 calls; later redesigns
     rank by device ms;
  4. the fit end to end, each path with the launch counts set to 0 just
     before it and read just after: the side config MultiHConfig(
     knn_window=False, knn_approx=False) on BASELINE config 2 (K1-K3);
     then the default config MultiHConfig() on BASELINE config 2 (exact
     recovery) and three golden scenes (K1-K5 and the list build), the
     same with mrf_fused_front=True (K6 once per PEARL iteration, no K4), the card
     fit against the CPU fit and the fused-front fit, and the warm fit
     latency at N=512 of the default, fused-front and side configs, one
     fit of each in turns;
  5. the stress fit at bench.py::_stress_cfg(10240, 102400,
     n_candidates=256, max_labels=16)'s settings (window sampling, the
     windowed graph; 10k points, 70% outliers, 8 planes), with every
     kernel but K6 launched; the same scene on the fused-front route (K6
     in place of K4), warm fits of both routes in turns, and once at the
     side config (row-blocked exact graph past N=4096, band with far
     edges; K1-K3);
  6. the fundamental-model fit: the motion suite's config
     MultiHConfig(model="fundamental", residual="sampson",
     n_hypotheses=2048, max_points=512) on fm2_b and fm4_a, 3 keys each,
     against the motion goldens (motion count exact on every key, mean
     misclassification within 2.0 pp), with the launches of every fit
     (K1 at f_sampson, K3, K4, K5; no K2, no K7), and the warm fit
     latency on fm4_a;
  7. one two-pass adaptive-threshold fit (fit_adaptive) on a noise-1 px
     scene, tau printed;
  8. run_stream on the CLI's `stream synth` defaults, warm-started and
     cold, at pipeline depths 1 and 3 (p50 / p95 ms, fps, mean planes);
  9. the mixed plane + motion fit (make_fit_mixed) at the mixed goldens'
     configs (max_points 1024, n_hypotheses 2048, max_labels 8, the F
     stage residual="sampson"): mx21_a and mx22_b, 3 keys each, against
     their goldens (class-resolved counts exact on every key, 3-key mean
     |delta| <= 3.5 pp), with the launches of every fit (K1 at both
     kinds, K2, K3, K4, K5 and the list build; no K6, no K7); one fit
     at max_points 640, where both stages take the gather-path labeling
     (no K4, K5 or list build), and one fit_mixed_adaptive on a noise-1
     px scene there (tau_h, tau_f printed); the warm latency (median of
     5) and the device busy time per fit at N=1024, with each stage's
     host and device ms (mixed_fit_h, mixed_fit_f, mixed_polish).
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
    "mean_field_fused_front": dict(
        source="multih_tpu_torch/csrc/mrf_kernel.cu",
        replaces="multih_tpu/ops/kernels/mrf_kernel.py:280"),
    # the neighbour list K4-K6 read in place of the band that K4's TPU
    # kernel streams (built once per fit beside the far-free band)
    "band_list": dict(
        source="multih_tpu_torch/csrc/mrf_kernel.cu",
        replaces="multih_tpu/ops/kernels/mrf_kernel.py:118"),
    "window_gather": dict(
        source="multih_tpu_torch/csrc/gather_kernel.cu",
        replaces="multih_tpu/ops/kernels/gather_kernel.py:94"),
}
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s, fp32 and
# fp64 non-tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12
PEAK_FP64_S = 34e12
# operations per (hypothesis, point) pair of the count kernel, counted
# from the residual formulas of csrc/residual_kernel.cu (mul, add, div,
# max, compare each one); per 9x9 eigensolve from the notes of
# csrc/eig_kernel.cu; per 4-point DLT solve counted from
# csrc/dlt_kernel.cu's solve (fp64, given to `bound` as the fp32
# operations of the same time)
COUNT_OPS = {"symmetric": 40, "transfer": 20, "sampson": 52,
             "f_symmetric": 39, "f_transfer": 25, "f_sampson": 37}
# reciprocals per pair of the count kernel (one MUFU op each with the
# fast reciprocal), and the MUFU rate: 16 a cycle on each of the 132 SMs
# at the 1.98 GHz boost clock (the Hopper white paper)
COUNT_RCPS = {"symmetric": 2, "transfer": 1, "sampson": 1,
              "f_symmetric": 2, "f_transfer": 1, "f_sampson": 1}
PEAK_MUFU_S = 16 * 132 * 1.98e9
# per solve (fp64), plus the (32, S) entry's 8 triangle areas and tests
# (fp32)
DLT_OPS = 520 * PEAK_FLOP_S / PEAK_FP64_S
DLT_TEST_OPS = 70
EIG_OPS = 13000
# per (label, point) of K6's front, counted from csrc/mrf_kernel.cu's
# mf_front: the residual (transfer 19, symmetric 40) and the data cost
# and base (8)
FRONT_OPS = {"symmetric": 48, "transfer": 27}


def sh(cmd: list[str]) -> str:
    """stdout of a short command (stderr appended on failure)."""
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    return (proc.stdout + ("" if proc.returncode == 0 else proc.stderr)).strip()


def card_line() -> str:
    return sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median "call ms" of fn(): one CUDA-event pair around one call on an
    idle card, so the window holds the wrapper's host work as well as the
    device work it enqueues."""
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


def device_ms(fn, reps: int = 50, tries: int = 5) -> float:
    """"Device ms" of fn(): the device time of every kernel and copy that
    `reps` warm calls ran (busy_us), over reps. No host work and no gap
    between launches is in it. A session that came back with no device
    events is taken again, up to `tries` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    busy = 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy = busy_us(prof.key_averages())
        if busy > 0:
            break
    check(busy > 0, "the profiler saw no device time")
    return busy / reps / 1e3


def cuda_launches(fn, calls: int = 10, tries: int = 5):
    """(launches a call, the device events of one call) of fn, from
    torch.profiler over `calls` warm calls. A profile can miss device
    events (a short window may come back empty), never add one: a session
    in which some event name does not occur a multiple of `calls` times
    lost events and is taken again, up to `tries` times; (None, []) when
    none came back whole."""
    import collections

    import torch
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


def busy_us(key_averages) -> float:
    """The self device time of every device event in a profile, in us:
    kernels and copies, not the record_function annotations (whose
    device ranges span their stage's wall time)."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in key_averages
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


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


def bound(n_bytes: float, n_ops: float,
          n_mufu: float = 0.0) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take, the
    largest of the bytes at the HBM rate, the operations at the fp32
    rate and the reciprocals at the MUFU rate."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = max(n_ops / PEAK_FLOP_S, n_mufu / PEAK_MUFU_S) * 1e3
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


def _sampler_rows(rng, s, device):
    """(32, S) sampler rows of `_quads` (row 8q + c = channel c of quad
    point q: x1, y1, x2, y2, avail) as the sampler hands them over (a
    transposed view, strides (1, 32)), with collinear triples, duplicate
    points, padded points (avail 0) and quads ~0.01 px wide, whose
    triangle areas straddle the 1e-4 degeneracy threshold."""
    import torch

    p1, p2 = _quads(rng, s)
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
    return torch.from_numpy(rows.reshape(s, 32)).to(device).T


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
    from multih_tpu_torch.utils import data

    return _suite_points(data.motion_suite_scene(name), n_pad, device)


def _suite_points(cs, n_pad, device):
    import torch

    from multih_tpu_torch import pad_points

    return [torch.from_numpy(a).to(device)
            for a in pad_points(cs.x1, cs.x2, None, n_pad)]


def _captured_normal_matrices(run, c: int, last: bool = False):
    """(c, 9, 9) normal matrices of a real refit on the card: the first
    (or the last) batch of c that run() hands the eigensolve, taken as it
    is handed over."""
    from multih_tpu_torch.ops import geometry

    seen = []
    solve = geometry.smallest_eigvecs

    def capture(atas, *args):
        if atas.shape[0] == c:
            seen.append(atas.clone())
        return solve(atas, *args)

    geometry.smallest_eigvecs = capture
    try:
        run()
    finally:
        geometry.smallest_eigvecs = solve
    check(len(seen) > 0, f"the fit made no C={c} refit")
    return seen[-1 if last else 0].contiguous()


def _f_refit_normal_matrices(dev):
    """The first C=256 batch of one motion fit on fm4_a (the LO refine
    of the 256 top-counted hypotheses)."""
    from multih_tpu_torch import make_fit_tau

    return _captured_normal_matrices(
        lambda: make_fit_tau(motion_cfg(512))(
            *_motion_points("fm4_a", 512, dev), _cpu_draws(0), 3.0), 256)


def _mixed_polish_normal_matrices(dev):
    """The last C=8 batch of one mixed fit on mx21_a at N=1024: the
    polish's second Tukey-weighted F refit of its Kf=8 motions."""
    from multih_tpu_torch import make_fit_mixed
    from multih_tpu_torch.utils import data

    pts = _suite_points(data.mixed_suite_scene("mx21_a"), 1024, dev)
    return _captured_normal_matrices(
        lambda: make_fit_mixed(*mixed_cfgs(1024))(*pts, _cpu_draws(0)), 8,
        last=True)


def eig_parity(atas, got):
    """Hold K3's eigenvectors `got` of the (C, 9, 9) normal matrices
    `atas`. float32 fixes a smallest eigenvector only to the first-order
    floor eps32 * lam_max / (lam_2 - lam_1), up to ~2e-3 on the F
    refits' matrices, whose smallest gaps are down to ~6e-5 of lam_max:
    the kernel must be within twice that floor of float64 eigh on every
    matrix (`ratio_plain` says how far the round-robin plain version
    gets), and where the floor is below 1e-5 within 1e-5 of the round-robin
    plain version (the kernel's order and rounding) and within 1e-4 of
    the cyclic one (the JAX twin's order). Returns a dict: `well` the
    count of those, `err` / `err_cyclic` the kernel's max-abs error
    there, `err_all` / `err_all_cyclic` over all, `ratio` /
    `ratio_plain` the largest error / floor of the kernel and of the
    round-robin plain version."""
    import torch

    from multih_tpu_torch.ops.kernels import eig_kernel as ek

    ev, vec = torch.linalg.eigh(atas.double())
    v64 = vec[..., 0]
    floor = torch.finfo(torch.float32).eps * ev[:, -1] / (ev[:, 1] - ev[:, 0])

    def err(v, to):
        sign = torch.sign((v.double() * to).sum(1, keepdim=True))
        return (v.double() * sign - to).abs().amax(1)

    rr = ek.smallest_eigvec_9x9_round_robin_reference(atas).double()
    cyc = ek.smallest_eigvec_9x9_batch_reference(atas).double()
    out = dict(ratio=float((err(got, v64) / floor).nan_to_num(0.0).max()),
               ratio_plain=float((err(rr, v64) / floor).nan_to_num(0.0)
                                 .max()))
    check(out["ratio"] <= 2.0, f"eig kernel C={atas.shape[0]}: "
          f"{out['ratio']:.3g} times the float32 floor from float64 eigh")
    well = floor < 1e-5
    e_rr, e_cyc = err(got, rr), err(got, cyc)
    out.update(well=int(well.sum()), err_all=float(e_rr.max()),
               err_all_cyclic=float(e_cyc.max()),
               err=float(e_rr[well].max()) if well.any() else 0.0,
               err_cyclic=float(e_cyc[well].max()) if well.any() else 0.0)
    check(out["err"] <= 1e-5 and out["err_cyclic"] <= 1e-4,
          f"eig kernel C={atas.shape[0]} where the float32 floor is below "
          f"1e-5: max abs err {out['err']} vs the round-robin plain "
          f"version, {out['err_cyclic']} vs the cyclic one")
    return out


def phase_kernels(dev):
    import torch

    from multih_tpu_torch.ops import fmodel, geometry
    from multih_tpu_torch.ops.kernels import _build, dlt_kernel, eig_kernel
    from multih_tpu_torch.ops.kernels import residual_kernel as rk
    from multih_tpu_torch.utils import data

    print("== 3. kernel parity and timing (kernel vs plain vs library; "
          "bound)")
    rng = np.random.default_rng(0)
    results = {}
    # the wrappers' raw stream handle is the current stream's, on a side
    # stream too
    x = torch.zeros(1, device=dev)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        check(_build.stream_handle(x) == side.cuda_stream,
              "stream handle: not the side stream's")
    check(_build.stream_handle(x) == torch.cuda.current_stream().cuda_stream,
          "stream handle: not the current stream's")

    def record(name, shape, err, kernel, plain, n_bytes, n_ops, lib=None,
               n_mufu=0.0):
        """Times kernel() (call ms and device ms), plain() (call ms) and
        the library call lib() (both) and prints one row."""
        b_ms, b_by = bound(n_bytes, n_ops, n_mufu)
        row = dict(shape=shape, ms=cuda_ms(kernel),
                   device_ms=device_ms(kernel),
                   plain_ms=cuda_ms(plain, reps=5), bound_ms=b_ms,
                   bound_by=b_by, library_ms=None, library_device_ms=None)
        if lib is not None:
            row.update(library_ms=cuda_ms(lib),
                       library_device_ms=device_ms(lib))
        lib_s = ("none" if lib is None else f"{row['library_ms']:8.4f} / "
                 f"{row['library_device_ms']:.4f} ms")
        print(f"{name:16s} {shape:34s} max_abs_err {err:<10.4g} kernel "
              f"call / device {row['ms']:8.4f} / {row['device_ms']:.4f} ms"
              f"  plain {row['plain_ms']:9.4f} ms  library {lib_s}"
              f"  bound {b_ms:.5f} ms ({b_by})")
        r = results.setdefault(name, dict(max_abs_err=0.0, shapes=[]))
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        r["shapes"].append(row)
        return row

    def count_rows(name, Hs, x1, x2, valid, kind):
        """K1 in both reciprocal modes against the plain version: max
        |dcount| <= 2 and mean < 0.5, then timed, with its CUDA launches
        a call; the bound counts the reciprocals at the MUFU rate too,
        and the launch shape and that MUFU time are printed beside it."""
        s, n = Hs.shape[0], x1.shape[0]
        ref = rk.inlier_counts_reference(Hs, x1, x2, valid, thr, kind)
        check(float(ref.max()) > 0, f"no inliers in the count check {kind}")
        for approx in (True, False):
            mode = "approx" if approx else "exact"

            def kernel():
                return rk.inlier_counts_padded(Hs, x1, x2, valid, thr,
                                               kind=kind, approx_rcp=approx)
            d = (kernel() - ref).abs()
            check(float(d.max()) <= 2.0 and float(d.mean()) < 0.5,
                  f"count kernel {kind} {mode} {s}x{n}: max "
                  f"{float(d.max())} mean {float(d.mean())}")
            row = record(name, f"{s}x{n} {kind} {mode}", float(d.max()),
                         kernel, lambda: rk.inlier_counts_reference(
                             Hs, x1, x2, valid, thr, kind),
                         4 * (s * 9 + 5 * n + s), s * n * COUNT_OPS[kind],
                         n_mufu=s * n * COUNT_RCPS[kind])
            n_launch, launched = cuda_launches(kernel)
            check(n_launch in (1, None), f"count kernel {kind} {s}x{n}: "
                  f"launches {launched}")
            row["launches_per_call"] = n_launch
            shape = rk.launch_shape(s, n, *rk._limits(Hs.device.index))
            print(f"  count {kind} {mode} {s}x{n}: {int(ref.sum())} "
                  f"inliers, mean |dcount| {float(d.mean()):.4f}, (warps, "
                  f"CTAs) {shape}; CUDA "
                  f"launches a call {_launch_str(n_launch, launched)}; "
                  f"reciprocals at the MUFU rate "
                  f"{s * n * COUNT_RCPS[kind] / PEAK_MUFU_S * 1e3:.5f} ms")

    # K1: hypotheses solved from scene quads, at the claim / verify sweep
    # (2051 x 512, symmetric) and the stress ranking sweep (102400 x 1280,
    # transfer); sampson at the small shape; more points than one
    # shared-memory tile holds (2051 x 10240: a cluster of 5 CTAs) and a
    # pool so small that a hypothesis's points are split over 8 warps in
    # each of a cluster of 8 CTAs (16 x 10240)
    x1, x2, valid = _scene_points(10000, 10240, 42, dev)
    thr = torch.full((), 9.0, device=dev)
    for s, n, kind in ((2051, 512, "symmetric"), (2051, 512, "sampson"),
                       (102400, 1280, "transfer"),
                       (2051, 10240, "symmetric"), (16, 10240, "symmetric")):
        idx = torch.from_numpy(rng.integers(0, 10000, (s, 4))).to(dev)
        Hs = geometry.homography_4pt_batch_qr(x1[idx], x2[idx]).contiguous()
        count_rows("inlier_counts", Hs, x1[:n], x2[:n], valid[:n], kind)

    # K1's epipolar kinds at the motion fit's verify shape (2048
    # hypotheses + 3 claims x 512 points), F's solved from 8-point
    # samples of the fm4_a scene
    x1, x2, valid = _motion_points("fm4_a", 512, dev)
    n_valid = int(valid.sum())
    for kind in ("f_sampson", "f_symmetric", "f_transfer"):
        idx = torch.from_numpy(rng.integers(0, n_valid, (2051, 8))).to(dev)
        Fs = fmodel.fundamental_8pt_batch_qr(x1[idx], x2[idx]).contiguous()
        count_rows("inlier_counts_f", Fs, x1, x2, valid, kind)

    # K1 at the mixed fit's stage verify shape (2048 hypotheses + 3
    # claims x 1024 points of mx21_a) in the two kinds its stages count:
    # H's from 4-point and F's from 8-point samples of its points
    x1, x2, valid = _suite_points(data.mixed_suite_scene("mx21_a"), 1024,
                                  dev)
    idx = torch.from_numpy(rng.integers(0, int(valid.sum()),
                                        (2051, 8))).to(dev)
    Hs = geometry.homography_4pt_batch_qr(x1[idx[:, :4]],
                                          x2[idx[:, :4]]).contiguous()
    count_rows("inlier_counts", Hs, x1, x2, valid, "symmetric")
    Fs = fmodel.fundamental_8pt_batch_qr(x1[idx], x2[idx]).contiguous()
    count_rows("inlier_counts_f", Fs, x1, x2, valid, "f_sampson")

    # K2: the minimal solves of a progressive round, default and stress,
    # from the sampler's (32, S) rows (ok exact, H's within 5e-4 of the
    # plain version where its float32 solve is well conditioned, and
    # within 1e-6 of float64 on every usable quad: the kernel solves in
    # double)
    for s in (512, 51200):
        gt = _sampler_rows(rng, s, dev)
        hs, ok = dlt_kernel.homography_4pt_gt(gt)
        ref_h, ref_ok = dlt_kernel.homography_4pt_gt_reference(gt)
        check(torch.equal(ok, ref_ok), f"DLT kernel S={s}: ok differs "
              f"from the plain version's on {int((ok != ref_ok).sum())}")
        check(bool(torch.isfinite(hs).all()), "DLT kernel: non-finite H")
        ref64 = dlt_kernel.homography_4pt_gt_reference(gt.double())[0]
        e_plain = (ref_h.double() - ref64).abs().amax((1, 2))
        well = (ref_ok > 0) & (e_plain < 1e-4)
        err = float((hs - ref_h).abs().amax((1, 2))[well].max())
        check(err < 5e-4, f"DLT kernel S={s}: max abs err {err}")
        ill = (ref_ok > 0) & ~well
        e64 = (hs.double() - ref64).abs().amax((1, 2))
        e_all = float(e64[ref_ok > 0].max())
        check(e_all < 1e-6, f"DLT kernel S={s}: max abs err {e_all} vs "
              f"float64 on the usable quads")
        e_k = float(e64[ill].max()) if ill.any() else 0.0
        print(f"  dlt S={s}: {int(ref_ok.sum())} usable quads, ok exact; "
              f"max abs err vs float64 {e_all:.3g} on them; "
              f"{int(ill.sum())} ill-conditioned, max abs err vs float64 "
              f"there: kernel {e_k:.3g}, plain "
              f"{float(e_plain[ill].max()) if ill.any() else 0.0:.3g}")
        row = record("dlt_4pt", f"S={s} (32, S) rows", err,
                     lambda: dlt_kernel.homography_4pt_gt(gt),
                     lambda: dlt_kernel.homography_4pt_gt_reference(gt),
                     4 * 30 * s, (DLT_OPS + DLT_TEST_OPS) * s)
        n_launch, launched = cuda_launches(
            lambda: dlt_kernel.homography_4pt_gt(gt))
        check(n_launch in (1, None), f"DLT S={s}: launches {launched}")
        row["launches_per_call"] = n_launch
        print(f"  dlt S={s}: CUDA launches a call "
              f"{_launch_str(n_launch, launched)}")

    # K3: homography normal matrices at the LO-refine batch
    # (n_candidates) and a PEARL refit batch (max_labels), then the 256 of
    # a real F refit on fm4_a (their smallest eigenvalue gaps differ from
    # the homography ones') and the 8 of the mixed polish's F refit; the
    # plain time is the round-robin version's
    sets = [(f"C={c}", _normal_matrices(rng, c).to(dev).contiguous())
            for c in (256, 16)]
    sets.append(("C=256 F normal matrices", _f_refit_normal_matrices(dev)))
    sets.append(("C=8 F normal matrices (mixed polish)",
                 _mixed_polish_normal_matrices(dev)))
    for shape, atas in sets:
        c = atas.shape[0]
        got = eig_kernel.smallest_eigvec_9x9_batch(atas)
        h = eig_parity(atas, got)
        print(f"  eig {shape}: {h['well']} of {c} with a float32 floor "
              f"below 1e-5, max abs err there {h['err']:.3g} vs the "
              f"round-robin plain version, {h['err_cyclic']:.3g} vs the "
              f"cyclic one; over all {h['err_all']:.3g}, "
              f"{h['err_all_cyclic']:.3g}; error / floor vs float64 eigh "
              f"at most: kernel {h['ratio']:.3g}, round-robin plain "
              f"{h['ratio_plain']:.3g}")
        if "F" not in shape:
            check(h["err_all_cyclic"] <= 1e-4, f"eig kernel {shape}: max "
                  f"abs err {h['err_all_cyclic']} vs the cyclic version")
        record("eig9_smallest", shape, h["err"],
               lambda: eig_kernel.smallest_eigvec_9x9_batch(atas),
               lambda: eig_kernel.smallest_eigvec_9x9_round_robin_reference(
                   atas),
               4 * 90 * c, EIG_OPS * c, lib=lambda: torch.linalg.eigh(atas))

    mrf_kernels(rng, dev, record)
    front_kernels(rng, dev, record)
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


def _launch_str(n, names) -> str:
    return ("not measured (the profiler lost events in every session)"
            if n is None else f"{n} ({', '.join(names)})")


def mrf_kernels(rng, dev, record):
    """The neighbour list, K4 and K5 at the default shape (L=17, N=512,
    B=256, 6 mean-field sweeps, 2 ICM starts x 2 iterations), the stress
    shape (L=17, N=10240, B=128, 4 sweeps, 2 starts x 1 iteration) and
    the mixed fit's stage shape (L=9, N=1024, B=256, 6 sweeps, 2 starts x
    2 iterations). K4 and K5 read the list the fit builds beside the band
    (its build is timed on its own); each call's CUDA launches are
    counted by torch.profiler. Bounds count the list's non-zeros: each
    pair (8 bytes) read once."""
    import torch

    from multih_tpu_torch.ops.kernels import mrf_kernel as mk

    sw = 0.1
    for l, n_points, n, block, sweeps, icm_it in (
            (17, 500, 512, 256, 6, 2), (17, 10000, 10240, 128, 4, 1),
            (9, 1000, 1024, 256, 6, 2)):
        _, _, valid, _, adj = _windowed_problem(dev, n_points, n, block)
        dct = torch.from_numpy(rng.uniform(0, 2.0, (l, n)).astype(
            np.float32)).to(dev) * valid[None, :]
        q0 = torch.softmax(-dct / 2.0, dim=0).contiguous()
        base = (dct + sw * adj.deg.T).contiguous()
        band, nbr = adj.band, adj.nbr
        inv_t = torch.from_numpy((1.0 / np.geomspace(2.0, 0.25, sweeps))
                                 .astype(np.float32)).to(dev)
        nnz = int((band != 0).sum())
        nb = n // block
        band_bytes = 4 * nb * block * 3 * block
        list_bytes = 8 * nnz + 4 * n
        shape = f"L={l} N={n} B={block}"

        got = mk.band_list(band)
        ref = mk.band_list_reference(band)
        check(all(torch.equal(a, b) for a, b in zip(got, ref))
              and all(torch.equal(a, b) for a, b in zip(nbr, ref)),
              f"neighbour list {shape}: not exact")
        record("band_list", f"N={n} B={block}", 0.0,
               lambda: mk.band_list(band),
               lambda: mk.band_list_reference(band),
               band_bytes + 8 * n * 3 * block + 4 * n, 0)
        print(f"  neighbour list {shape}: non-zeros {nnz} of "
              f"{nb * block * 3 * block} ({100.0 * nnz / (nb * block * 3 * block):.2f}%), "
              f"{nnz / n:.2f} a row, at most {int(nbr.cnt.max())}")

        got = mk.mean_field_fused(q0, base, band, inv_t, sw, nbr=nbr)
        ref = mk.mean_field_fused_reference(q0, base, band, inv_t, sw)
        err = float((got - ref).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= 1e-5,
              f"mean-field kernel {shape}: max abs err {err}")
        row = record("mean_field_fused", f"{shape} sweeps={sweeps}", err,
                     lambda: mk.mean_field_fused(q0, base, band, inv_t, sw,
                                                 nbr=nbr),
                     lambda: mk.mean_field_fused_reference(q0, base, band,
                                                           inv_t, sw),
                     list_bytes + 4 * (3 * l * n + sweeps),
                     sweeps * (2 * nnz * l + 8 * l * n))
        n_launch, launched = cuda_launches(lambda: mk.mean_field_fused(
            q0, base, band, inv_t, sw, nbr=nbr))
        check(n_launch in (1, None), f"mean-field {shape}: launches "
              f"{launched}")
        # every sweep in one launch: one more sweep's device time, from a
        # 1-sweep call against the S-sweep one
        one = device_ms(lambda: mk.mean_field_fused(q0, base, band,
                                                    inv_t[:1], sw, nbr=nbr))
        row.update(launches_per_call=n_launch,
                   one_sweep_device_ms=one,
                   per_sweep_device_ms=(row["device_ms"] - one)
                   / (sweeps - 1))
        print(f"  mean-field {shape}: CUDA launches a call "
              f"{_launch_str(n_launch, launched)}; 1 sweep {one:.4f} device ms, each further "
              f"sweep {row['per_sweep_device_ms']:.4f} device ms")

        starts = torch.stack([
            torch.argmin(dct, dim=0),
            torch.from_numpy(rng.integers(0, l, n)).to(dev),
        ]).to(torch.int32).contiguous()
        got = mk.icm_fused(starts, base, band, icm_it, sw, nbr=nbr)
        ref = mk.icm_fused_reference(starts, base, band, icm_it, sw)
        err = float((got - ref).abs().max())
        check(err == 0, f"ICM kernel {shape}: labels differ ({err})")
        check(bool((got != starts).any()), "ICM kernel moved no label")
        s = starts.shape[0]
        row = record("icm_fused", f"{shape} S={s} iterations={icm_it}", err,
                     lambda: mk.icm_fused(starts, base, band, icm_it, sw,
                                          nbr=nbr),
                     lambda: mk.icm_fused_reference(starts, base, band,
                                                    icm_it, sw),
                     list_bytes + 4 * (2 * s * n + l * n),
                     icm_it * s * (nnz * l + 3 * l * n))
        n_launch, launched = cuda_launches(lambda: mk.icm_fused(
            starts, base, band, icm_it, sw, nbr=nbr))
        check(n_launch in (1, None), f"ICM {shape}: launches {launched}")
        row["launches_per_call"] = n_launch
        print(f"  ICM {shape}: CUDA launches a call "
              f"{_launch_str(n_launch, launched)}")


def front_kernels(rng, dev, record):
    """K6 at the default shape (L=17, N=512, B=256, 6 sweeps) and the
    stress shape (L=17, N=10240, B=128, 4 sweeps), both homography kinds,
    thr a device tensor: r to rtol 1e-3 / atol 1e-4 of the plain
    version's up to 1e6 px^2 (saturated past it) and min(r/thr, 8) to
    atol 1e-4 everywhere, dct equal to data_costs_t of the kernel's own
    r (rtol 2e-6), q within 1e-5 of the plain sweeps on the kernel's own
    dct and within 1e-4 of the plain version (its max_abs_err). 15
    near-identity planes, one inactive, and a wild one whose residuals
    reach the truncation; the scene's own points."""
    import torch

    from multih_tpu_torch.models import labeling
    from multih_tpu_torch.ops.kernels import mrf_kernel as mk

    l, sw = 17, 0.1
    for n_points, n, block, sweeps in ((500, 512, 256, 6),
                                       (10000, 10240, 128, 4)):
        x1, x2, valid, _, adj = _windowed_problem(dev, n_points, n, block)
        hs = np.eye(3)[None] + rng.normal(0, 0.02, (l - 1, 3, 3))
        hs[:, 0, 2] += rng.normal(0, 5.0, l - 1)  # pixel shifts
        hs[-1] = rng.normal(0, 1.0, (3, 3))
        hs = torch.from_numpy(hs.astype(np.float32)).to(dev)
        active = torch.ones(l - 1, device=dev)
        active[1] = 0.0
        q0 = torch.softmax(torch.from_numpy(rng.normal(size=(l, n)).astype(
            np.float32)).to(dev), 0)
        thr = torch.tensor(9.0, device=dev)
        pts, hm = labeling.pack_front(x1, x2, valid, hs, active, sw, adj)
        inv_t = torch.from_numpy((1.0 / np.geomspace(2.0, 0.25, sweeps))
                                 .astype(np.float32)).to(dev)
        nnz = int((adj.band != 0).sum())
        shape = f"L={l} N={n} B={block}"
        for kind in ("symmetric", "transfer"):
            args = (q0, pts, hm, adj.band, inv_t, thr, sw, 1.0, kind)

            def kernel():
                return mk.mean_field_fused_front(*args, nbr=adj.nbr)

            def plain():
                return mk.mean_field_fused_front_reference(*args)

            (q, dct, r), (q_ref, _, r_ref) = kernel(), plain()
            # past 1e6 px^2 w nears zero and float32 cancellation sets
            # r's digits (tests/test_torch_kernels.py); the cost is
            # saturated there on both sides
            near = r_ref <= 1e6
            torch.testing.assert_close(r[near], r_ref[near], rtol=1e-3,
                                       atol=1e-4)
            check(bool((r[~near] > 8.0 * thr).all()),
                  f"fused front {shape} {kind}: unsaturated far residual")
            torch.testing.assert_close(torch.clamp_max(r / thr, 8.0),
                                       torch.clamp_max(r_ref / thr, 8.0),
                                       rtol=0, atol=1e-4)
            torch.testing.assert_close(
                dct, labeling.data_costs_t(r, valid, thr, 1.0, active),
                rtol=2e-6, atol=1e-6)
            # q: K4's 1e-5 against the plain sweeps on the kernel's own
            # dct; 1e-4 end to end, where r's last-bit differences (px -
            # u cancels) reach q through 1/T up to 4
            err = float((q - q_ref).abs().max())
            err_own = float((q - mk.mean_field_fused_reference(
                q0, dct + pts[5:6], adj.band, inv_t, sw)).abs().max())
            check(bool(torch.isfinite(q).all()) and err_own <= 1e-5
                  and err <= 1e-4, f"fused front {shape} {kind}: q max abs "
                  f"err {err_own} (own dct), {err} (plain version)")
            rel = (r - r_ref).abs() / r_ref.abs().clamp_min(1e-4)
            print(f"  front {shape} {kind}: q max abs err {err_own:.3g} "
                  f"vs the plain sweeps on its own dct; r max rel err "
                  f"{float(rel[near].max()):.3g} up to 1e6 px^2, "
                  f"{float(rel.max()):.3g} over all; "
                  f"{int((~near).sum())} of {r.numel()} residuals past "
                  f"1e6 px^2, max {float(r.max()):.3g}")
            # inputs q0, pts (8, N), hm (L, 19), the list's pairs,
            # inv_temps, thr read once; q, dct (L, N) and r (K, N) written
            # once
            n_bytes = (8 * nnz + 4 * n
                       + 4 * (l * n + 8 * n + 19 * l + sweeps + 1)
                       + 4 * (2 * l * n + (l - 1) * n))
            n_ops = (sweeps * (2 * nnz * l + 8 * l * n)
                     + FRONT_OPS[kind] * l * n)
            row = record("mean_field_fused_front", f"{shape} "
                         f"sweeps={sweeps} {kind}", err, kernel, plain,
                         n_bytes, n_ops)
            n_launch, launched = cuda_launches(kernel)
            check(n_launch in (2, None), f"fused front {shape}: launches "
                  f"{launched}")
            row["launches_per_call"] = n_launch
            print(f"  front {shape} {kind}: CUDA launches a call "
                  f"{_launch_str(n_launch, launched)}")


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
        lib = None
        if mode == "index":
            idx = sel.clamp(0, rows - 1).long()[:, :, None].expand(-1, -1, c)

            def lib():
                return torch.gather(win, 1, idx)
        record("window_gather", f"{mode} nb={nb} 3B={rows} C={c} T={t}",
               0.0, lambda: gk.window_gather(win, sel, mode),
               lambda: gk.window_gather_reference(win, sel, mode),
               4 * (nb * rows * c + nb * t + nb * c * t), 0, lib=lib)


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
        "inlier_counts": residual_kernel.inlier_counts_padded,
        "dlt_4pt": dlt_kernel.homography_4pt_gt,
        "eig9_smallest": eig_kernel.smallest_eigvec_9x9_batch,
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

    def golden_path(label, **kw):
        """BASELINE config 2 and the golden scenes at MultiHConfig(**kw)."""
        planes, err = _baseline2(dev, MultiHConfig(max_points=1024, **kw),
                                 gen)
        print(f"{label}, BASELINE config 2: planes {planes}, "
              f"misclassification {err:.4f}%")
        check(err == 0.0 and planes == 2,
              f"{label}: BASELINE config 2 not recovered exactly")
        fits = {}
        for name, npad in GOLDEN_SCENES:
            g = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npz"))
            cs = data.suite_scene(name)
            cfg = MultiHConfig(max_points=npad, **kw)
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
            print(f"{label}, golden {name} (npad {npad}, tau {tau}): planes "
                  f"{int(res.active.sum())} (golden {int(g['n_planes'])}), "
                  f"misclassification {err:.3f}% (golden "
                  f"{float(g['misclassification']):.3f}%), agreement with "
                  f"the golden labels {agree:.2f}%")
            check(agree >= 97.0, f"{label} {name}: agreement {agree:.2f}% "
                  f"< 97%")
            fits[name] = (cfg, args, tau)
        return fits

    golden_fits, launches["default"] = count_launches(
        "default-config", k123 + ("mean_field_fused", "icm_fused",
                                  "band_list"),
        lambda: golden_path("default config"))
    # the fused-front route: K6 takes the place of the residuals, data
    # costs and K4 in every PEARL iteration; K4 does not run
    fused_fits, launches["fused_front"] = count_launches(
        "fused-front", k123 + ("mean_field_fused_front", "icm_fused",
                               "band_list"),
        lambda: golden_path("fused front", mrf_fused_front=True))
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
    cfg, args, tau = golden_fits["easy2_a"]
    f = mt.make_fit_tau(cfg)
    f_fused = mt.make_fit_tau(fused_fits["easy2_a"][0])
    lab_gpu = f(*args, _cpu_draws(1), tau).labels.cpu().numpy()
    lab_cpu = f(*[a.cpu() for a in args], _cpu_draws(1), tau).labels.numpy()
    lab_fused = f_fused(*args, _cpu_draws(1), tau).labels.cpu().numpy()
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

    # warm fit latency at N=512 (S=2048), host clock to synchronize: the
    # default config, the fused-front route and the side config on the
    # same scene, one fit of each in turns (the host drifts within a call)
    routes = (("default", f), ("fused_front", f_fused),
              ("side", mt.make_fit_tau(_slice_cfg(max_points=512))))
    times = {label: [] for label, _ in routes}
    for _ in range(20):
        for label, fn in routes:
            times[label] += host_ms(lambda: fn(*args, gen, tau), reps=1)
    lat = {}
    for label, t in times.items():
        lat[label] = dict(median_ms=statistics.median(t), min_ms=min(t),
                          max_ms=max(t), reps=len(t))
        print(f"warm fit latency easy2_a N=512, {label} config: median "
              f"{lat[label]['median_ms']:.2f} ms (min "
              f"{lat[label]['min_ms']:.2f}, max {lat[label]['max_ms']:.2f},"
              f" {len(t)} fits, in turns)")
    return launches, lat, lambda: (
        _profile("N=512 easy2_a, default config", lambda: f(*args, gen, tau)),
        _profile("N=512 easy2_a, fused front",
                 lambda: f_fused(*args, gen, tau)))


STAGES = ("knn_graph", "banded_adjacency", "sampling_knn", "hypothesize",
          "verify", "lo_refine", "select", "pearl", "split_refine",
          "union_refit_merge", "f_refine_phases", "finalize", "mixed_fit_h",
          "mixed_fit_f", "mixed_polish", "mixed_probe_h", "mixed_probe_f")


def stage_ms(key_averages, reps: int) -> dict:
    """{stage: (host ms, device ms)} per call of each STAGES range in a
    profile: the range's host wall time, and the device time of the
    kernels and copies launched inside it (its children's, recursively:
    FunctionEvent.device_time_total)."""
    from torch.autograd import DeviceType

    return {e.key: (e.cpu_time_total / reps / 1e3,
                    e.device_time_total / reps / 1e3)
            for e in key_averages
            if e.key in STAGES and e.device_type == DeviceType.CPU
            and e.cpu_time_total > 0}


def _profile(label: str, fn, reps: int = 5):
    """torch.profiler over `reps` warm calls of fn: device time by op and
    kernel (printed), the device busy time (busy_us) and
    each stage's host and device time per call (stage_ms). Returns
    (busy ms per call, stage_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    print(f"== profile: {label}, {reps} fits")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    print(ka.table(sort_by="self_cuda_time_total", row_limit=20))
    busy = busy_us(ka) / reps / 1e3
    print(f"device busy {busy:.3f} ms/fit ({reps} fits)")
    stages = stage_ms(ka, reps)
    for name, (host, dev) in stages.items():
        print(f"stage {name:17s} host {host:9.3f} ms/fit, device "
              f"{dev:8.3f} ms/fit")
    return busy, stages


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
        "stress", tuple(k for k in KERNELS
                        if k not in ("inlier_counts_f",
                                     "mean_field_fused_front")),
        lambda: f(*args, gen))
    cold = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(res.homographies).all()), "non-finite H")
    lab = res.labels.cpu().numpy()
    check(lab.min() >= 0 and lab.max() <= cfg.max_labels, "labels range")
    err = evaluation.misclassification_error(lab, gt, cfg.max_labels)
    out = dict(planes=int(res.active.sum()), misclassification=err,
               n_far_dropped=int(res.n_far_dropped), first_fit_ms=cold)
    print(f"stress: planes {out['planes']} of 8, misclassification "
          f"{err:.3f}%, n_far_dropped {out['n_far_dropped']}, first fit "
          f"{cold:.1f} ms")
    check(out["planes"] == 8, f"stress: {out['planes']} planes of 8")
    check(out["n_far_dropped"] == 0, "stress: far edges dropped")

    # the same scene on the fused-front route: K6 once per PEARL
    # iteration in place of K4, every other kernel as before
    f_fused = mt.make_fit(dataclasses.replace(cfg, mrf_fused_front=True))
    res, fused_launches = count_launches(
        "fused-front stress", tuple(k for k in KERNELS
                                    if k not in ("inlier_counts_f",
                                                 "mean_field_fused")),
        lambda: f_fused(*args, gen))
    check(fused_launches["mean_field_fused_front"] == cfg.pearl_iterations
          and fused_launches["mean_field_fused"] == 0,
          f"fused-front stress launches: {fused_launches}")
    check(bool(torch.isfinite(res.homographies).all()), "non-finite H")
    err = evaluation.misclassification_error(res.labels.cpu().numpy(), gt,
                                             cfg.max_labels)
    # warm fits of the two routes, one of each in turns
    warm = {"default": [], "fused_front": []}
    for _ in range(4):
        warm["default"] += host_ms(lambda: f(*args, gen), reps=1)
        warm["fused_front"] += host_ms(lambda: f_fused(*args, gen), reps=1)
    out["warm_ms"] = warm["default"]
    out["fused_front"] = dict(planes=int(res.active.sum()),
                              misclassification=err,
                              warm_ms=warm["fused_front"])
    print(f"fused-front stress: planes {out['fused_front']['planes']} of 8, "
          f"misclassification {err:.3f}%")
    for label, t in warm.items():
        print(f"stress warm fits, {label}, in turns: "
              f"{', '.join(f'{x:.1f}' for x in t)} ms")
    check(out["fused_front"]["planes"] == 8,
          f"fused-front stress: {out['fused_front']['planes']} planes of 8")

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
    return (out, launches, side_launches, fused_launches,
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
              "icm_fused", "band_list")
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
    args = _to(dev, x1, x2, valid)
    f = mt.make_fit_adaptive(cfg)
    gen = torch.Generator(device=dev)
    (res, tau), launches = count_launches(
        "adaptive", ("inlier_counts", "dlt_4pt", "eig9_smallest",
                     "mean_field_fused", "icm_fused", "band_list"),
        lambda: f(*args, gen.manual_seed(0)))
    check(tau.device.type == "cuda", "tau left the card")
    err = evaluation.misclassification_error(res.labels.cpu().numpy(), gt,
                                             cfg.max_labels)
    times = host_ms(lambda: f(*args, gen), reps=5)
    out = dict(tau=float(tau), planes=int(res.active.sum()),
               misclassification=err, warm_ms=times)
    print(f"adaptive fit, noise 1 px: tau {out['tau']:.4f} px, planes "
          f"{out['planes']} of 3, misclassification {err:.3f}%, warm "
          f"two-pass fits {', '.join(f'{t:.1f}' for t in times)} ms")
    check(4.5 < out["tau"] < 7.5, f"adaptive tau {out['tau']}")
    check(out["planes"] == 3 and err < 3.0, f"adaptive fit: {out}")
    return out, launches


def phase_stream(dev):
    """run_stream on the CLI's `stream synth` defaults: SyntheticStream(
    n_frames=30, n_points=480, n_planes=3) at MultiHConfig(max_points=512,
    n_hypotheses=1024), budget 33.3 ms, per-frame upload; warm-started
    and cold, at pipeline depths 1 and 3, and warm at depth 3 with the
    frames preloaded. Each run is one path for the launch counts."""
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
                                "mean_field_fused", "icm_fused",
                                "band_list"),
            lambda: streaming.run_stream(
                streaming.SyntheticStream(n_frames=30, n_points=480,
                                          n_planes=3, seed=0),
                cfg, budget_ms=33.3, seed=0, pipeline_depth=depth,
                warm_start=warm, upload=upload), quiet=True)
        out[label] = dict(dataclasses.asdict(st),
                          meets_budget=st.meets_budget())
        print(f"stream {label}: frames {st.frames}, p50 {st.p50_ms:.2f} ms, "
              f"p95 {st.p95_ms:.2f} ms, fps {st.fps:.2f}, mean planes "
              f"{st.mean_planes:.3f}, over budget {st.frames_over_budget}, "
              f"meets 33.3 ms budget {st.meets_budget()}")
        check(st.frames == 30 and st.mean_planes >= 2.5,
              f"stream {label}: {st}")
    total = {k: sum(c[k] for c in launches.values())
             for k in next(iter(launches.values()))}
    print("kernel launches on the stream path (5 runs):", total)
    return out, total


MIXED_SCENES = ("mx21_a", "mx22_b")


def mixed_cfgs(npad: int):
    """The mixed goldens' configs (tests/test_golden_parity.py:217-223)."""
    from multih_tpu_torch import MultiHConfig

    cfg_h = MultiHConfig(max_points=npad, n_hypotheses=2048, max_labels=8)
    return cfg_h, dataclasses.replace(cfg_h, model="fundamental",
                                      residual="sampson")


def _class_counts(res):
    act, is_f = res.active.cpu().numpy(), res.is_f.cpu().numpy()
    return int(act[is_f == 0].sum()), int(act[is_f == 1].sum())


def phase_mixed(dev):
    """The mixed plane + motion fit: the golden contract on mx21_a and
    mx22_b at N=1024 (banded stages), one fit and one adaptive fit at
    N=640 (the gather-path labeling in both stages; tests/test_mixed.py's
    TestMixedScene and TestMixedAdaptiveTau cases), the launches of every
    fit, the warm latency and device busy time per fit at N=1024."""
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import data, evaluation

    print("== 9. the mixed plane + motion fit on the card")
    banded = ("inlier_counts", "inlier_counts_f", "dlt_4pt",
              "eig9_smallest", "mean_field_fused", "icm_fused", "band_list")
    cfg_h, cfg_f = mixed_cfgs(1024)
    k_union = cfg_h.max_labels + cfg_f.max_labels
    f = mt.make_fit_mixed(cfg_h, cfg_f)
    results, per_fit, path = {}, [], {}

    def tally(launches, into):
        per_fit.append(launches)
        for kname, c in launches.items():
            into[kname] = into.get(kname, 0) + c

    for name in MIXED_SCENES:
        g = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npz"))
        cs = data.mixed_suite_scene(name)
        args = _to(dev, *mt.pad_points(cs.x1, cs.x2, None, 1024))
        counts, errs = [], []
        for k in range(3):
            # the CPU generator of key k, as tests/test_torch_mixed.py
            res, fit_launches = count_launches(
                f"mixed {name} key {k}", banded,
                lambda: f(*args, _cpu_draws(k)), quiet=True)
            check(fit_launches["mean_field_fused_front"] == 0
                  and fit_launches["window_gather"] == 0,
                  f"mixed fit launched K6 or K7: {fit_launches}")
            tally(fit_launches, path)
            check(bool(torch.isfinite(res.models[res.active > 0]).all()),
                  "non-finite model")
            lab = res.labels.cpu().numpy()[: cs.n_points]
            check(lab.min() >= 0 and lab.max() <= k_union, "labels range")
            counts.append(_class_counts(res))
            errs.append(evaluation.misclassification_error(
                lab, cs.gt_labels, k_union))
        g_f = int(g["n_fundamental"])
        golden = (int(g["n_planes"]) - g_f, g_f)
        golden_err = float(g["misclassification"])
        delta = float(np.mean(errs)) - golden_err
        results[name] = dict(counts=counts, misclassification=errs,
                             golden_misclassification=golden_err,
                             golden_counts=golden, delta=delta)
        print(f"mixed {name} (N=1024): (planes, motions) {counts} (golden "
              f"{golden}), misclassification {np.mean(errs):.3f}% (golden "
              f"{golden_err:.3f}%), delta {delta:+.3f} pp")
        check(counts == [golden] * 3, f"{name}: class counts {counts}, "
              f"golden {golden}")
        check(abs(delta) <= 3.5, f"{name}: delta {delta:+.3f} pp > 3.5")
    print("kernel launches per mixed fit:",
          [{k: v for k, v in c.items() if v} for c in per_fit])
    print("kernel launches on the mixed path:", path)

    # N=640: no multiple of agree_block 256, so both stages (and the
    # polish, as always) take the gather-path labeling: no band, no list,
    # no K4 / K5
    cfg_h6, cfg_f6 = mixed_cfgs(640)
    gather = {}
    no_band = ("mean_field_fused", "icm_fused", "band_list",
               "mean_field_fused_front", "window_gather")
    cs, _, _ = data.synthetic_mixed_scene(600, 2, 1, 0.1, 0.5, seed=4)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 640)
    args = _to(dev, x1, x2, valid)
    res, fit_launches = count_launches(
        "mixed N=640 (gather path)", ("inlier_counts", "inlier_counts_f",
                                      "dlt_4pt", "eig9_smallest"),
        lambda: mt.make_fit_mixed(cfg_h6, cfg_f6)(*args, _cpu_draws(0)))
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
    args = _to(dev, x1, x2, valid)
    (res, tau_h, tau_f), fit_launches = count_launches(
        "mixed adaptive N=640", ("inlier_counts", "inlier_counts_f",
                                 "dlt_4pt", "eig9_smallest"),
        lambda: mt.make_fit_mixed_adaptive(cfg_h6, cfg_f6)(
            *args, _cpu_draws(0)))
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

    # warm latency and device busy time per fit at N=1024, mx21_a
    cs = data.mixed_suite_scene("mx21_a")
    args = _to(dev, *mt.pad_points(cs.x1, cs.x2, None, 1024))
    gen = torch.Generator(device=dev).manual_seed(0)
    times = host_ms(lambda: f(*args, gen), reps=5)
    lat = dict(median_ms=statistics.median(times), min_ms=min(times),
               max_ms=max(times), reps=len(times))
    print(f"warm mixed fit latency mx21_a N=1024: median "
          f"{lat['median_ms']:.2f} ms (min {lat['min_ms']:.2f}, max "
          f"{lat['max_ms']:.2f}, {len(times)} fits)")
    busy, stages = _profile("N=1024 mx21_a, mixed fit",
                            lambda: f(*args, gen), reps=3)
    out = dict(scenes=results, n640=out_640, adaptive=adaptive,
               latency_mx21_a=lat, busy_ms=busy,
               idle_share=1.0 - busy / lat["median_ms"],
               stages={k: dict(host_ms=h, device_ms=d)
                       for k, (h, d) in stages.items()},
               launches_per_fit=per_fit)
    print(f"mixed fit N=1024: device busy {busy:.3f} ms of "
          f"{lat['median_ms']:.2f} ms, idle share {out['idle_share']:.3f}")
    return out, path, gather


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the N=512 (default and fused-front), "
                         "stress, motion and mixed fits")
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
     launches["fused_front_stress"], profile_stress) = phase_stress(dev)
    motion, launches["motion"], profile_motion = phase_motion(dev)
    adaptive, launches["adaptive"] = phase_adaptive(dev)
    stream, launches["stream_run"] = phase_stream(dev)
    mixed, launches["mixed"], launches["mixed_gather"] = phase_mixed(dev)
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
            ms=main_shape["ms"], device_ms=main_shape["device_ms"],
            plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"],
            library_device_ms=main_shape["library_device_ms"],
            launches_by_path={p: c[name] for p, c in launches.items()},
            shape=main_shape["shape"], shapes=kernels[name]["shapes"],
        ))
    print(json.dumps({"kernels": rows, "fit_latency_n512": latency,
                      "stress": stress, "motion": motion,
                      "adaptive": adaptive, "stream": stream,
                      "mixed": mixed}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
