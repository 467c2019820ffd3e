#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port of the Multi-H fit on one GPU: the
homography fit (default and fused-front routes), the fundamental
(multi-motion) fit, the adaptive-threshold fit, the frame stream, the
mixed plane + motion fit, the batch surface, the affine one-point pool,
the direct refit, the CLI, the mesh axes ('pair', 'hyp', 'pt') and the
dryrun of every mesh path.

Run from the repository root on a host with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns of
                                     # the N=512, stress, motion and
                                     # mixed fits

Phases, each raising on failure:
  1. environment: torch / CUDA / nvcc / triton / cv2, the card's name
     and power limit, TF32 off;
  2. build: nvcc compiles multih_tpu_torch/csrc/*.cu, one process per
     source (build seconds and the ptxas register / spill report);
  3. kernel parity: every kernel against its plain PyTorch version on the
     card at the main paths' shapes (K1 in both reciprocal modes, also
     past one shared-memory tile, on a split point axis, at its
     epipolar kinds on the motion fit's verify shape and at both kinds
     on the mixed stages' (2051 x 1024), with its CUDA launches a call:
     1; K2 from the sampler's (32, S) rows with degenerate and padded
     quads, ok exact, H's within 5e-4 of the plain version and 1e-6 of
     float64, 1 launch a call, its library call batched
     torch.linalg.solve_ex on the plain version's (S, 8, 8) float64
     systems; K3 at the LO-refine batch C=256 and a
     PEARL batch C=16 and on the F normal matrices of a real refit in a
     motion fit and in the mixed polish (C=8), held to float64 eigh too;
     K6 at both homography kinds on the fit's own tensors with the
     threshold a device tensor, its r and cost held to float64 too and
     its q equal to K4's on its own base; the neighbour list bit-exact;
     K4, K5 and K6 on the list the fit builds, K4, K5 and the list also
     at the mixed stages' L=9, N=1024, with their CUDA launches a call
     counted by torch.profiler: 1 each),
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
     host and device ms (mixed_fit_h, mixed_fit_f, mixed_polish);
 10. the batch surface, the affine pool, the direct refit and the CLI:
     parallel/sharding.run_benchmark_batch on the 24 homography golden
     scenes padded to max_points 1024 at the default config with the
     golden taus (each pair >= 97% in agreement with its golden labels
     and equal to its single fit on the card with the same generator),
     the batch's wall time against the sum of its pairs' warm single
     fits (3 runs each, in turns) and its device busy time; the affine
     one-point fit (fit(affines=...), 300 points, 2 planes, error < 3%,
     warm ms with and without the pool, the pool on the card against the
     CPU's on one F); the direct-refit fit (refit_moments=False) on
     BASELINE config 2 (exact recovery; no K3); `python -m
     multih_tpu_torch.cli synth --json` as a subprocess on the card;
 11. the mesh axes (parallel/mesh.py, parallel/sharding.py): two gloo
     ranks share the one card (NCCL refuses two ranks on one device;
     gloo copies the gathered CUDA tensors through the host, counted in
     bytes). On a (1, 2) mesh: hyp_sharded_fit of phase 5's stress scene
     at the stress settings (each rank runs K7, K2 and K1 on its half of
     the 102400-hypothesis pool; K3-K5 replicated) and of the motion
     config on fm4_a, each equal to the single card fit with the same
     CUDA generator seed (labels, active and n_hypotheses_ok exact, H's
     within rtol 2e-4 / atol 2e-5, 8/8 planes), each rank's launches of
     K1, K2 and K7, its hypothesize + verify device ms from
     utils/tracing.py, and sharded_verification of the stress pool equal
     to the unsharded stable top-M; on a (2, 1) mesh, run_benchmark_batch
     of phase 10's 24 scenes equal to phase 10's batch; the sharded and
     single warm walls and the bytes staged through the host; then
     sharded_verification on a one-rank NCCL mesh (a real NCCL
     all_gather on the card);
 12. the 'pt' (point) axis: two gloo ranks share the card on a (pt=2)
     mesh, each owning half of the Morton blocks (its k-NN rows, band,
     residuals, data costs, q and labels), generation replicated, a
     halo exchanged before every K4 sweep and K5 half-sweep (a launch
     each), counts and float64 energies summed over the axis, the
     refits' weights gathered. On BASELINE config 2 (N=1024), the
     stress cell (N=10240), the F model on fm4_a at the motion suite's
     config (N=512, held to the motion bound |delta| <= 2.0 pp) and at
     full width (10000 points, 4 motions, N=10240, agree_block 128), and
     BASELINE config 2 on the exact graph (the side config: its far
     edges' columns gathered once a sweep, no K4 or K5): labels, active
     and n_far_dropped equal to the single card fit, the energy within
     rtol 1e-3, each rank's launches of every kernel equal to the
     single fit's (K4 and K5 times their sweeps a call: a launch a
     sweep), the host-staged bytes of a fit and of one sweep's
     agreement, each rank's peak allocated memory beside the single
     fit's and the warm walls; then K4 and K5 on each rank's window at
     the stress shape, its own blocks bit-equal to the unsharded launch;
 13. tools/torch_dryrun_multichip.py (the port's dryrun_multichip) on
     two gloo ranks sharing the card: the 'pair' and pair x hyp batches,
     sharded verification, the hyp-sharded F fit, the 'pt' homography
     and F fits and the pair-sharded mixed fit at the reference's tiny
     shapes, each asserted on known labels, each rank's launches
     counted;
 14. the homography fit's four kinds captured as CUDA graphs
     (utils/aot.cached_fit): fit at the default config on easy2_a (N=512)
     and on BASELINE config 2 (N=1024, exact from the replay), fit on the
     fused-front route (K6) and at the stress cell (K7, N=10240),
     fit_tau, fit_seeded (the stream's seeds) and fit_adaptive. On each:
     no synchronizing call in the eager fit (sync debug mode), eager
     equal to eager, the first call (warm-up, capture, replay) and a
     second seed's replay equal to their eager twins bit for bit with the
     generator left in the same state, the launches a replay by kernel
     (the wrappers' counts during the capture), the capture's seconds
     and graph pool bytes; at N=512, N=1024 and the stress cell the warm
     median of replay and eager in turns, the device busy time of each
     and the profiler's kernels in a replay (where the profile came back
     whole). Then `python -m
     multih_tpu_torch.cli synth --aot --json` in a fresh process on an
     empty and on a filled cache root, beside the run without --aot (the
     same results), and a truncated library under a temporary cache root
     rebuilt once.
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
# per (plane, point) of K6's front, counted from csrc/mrf_kernel.cu's
# mf_front_grid: the residual (transfer 21, symmetric 43: 4 a homogeneous
# coordinate, 2 the w guard, a divide a coordinate, 5 the squared
# distance, and 2 adds more for the back transfer's) and the data cost
# and base (8); per point, sw*deg and the outlier row's cost and base
# (3); per plane, the adjugate (27, symmetric only)
FRONT_OPS = {"symmetric": 51, "transfer": 29}


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


def _dlt_systems(gt):
    """The (S, 8, 8) float64 systems A h = b of K2's plain version on the
    sampler's (32, S) rows: its Hartley-normalized DLT rows
    (geometry.homography_4pt) with h33 = 1, A their first 8 columns and b
    minus the last; and a function that turns solve's (S, 8) solutions
    into Frobenius-normalized H's the plain version's way."""
    import torch

    from multih_tpu_torch.ops import geometry

    s = gt.shape[1]
    quad = torch.stack([gt[8 * q:8 * q + 4] for q in range(4)])  # (4, 4, S)
    x1 = quad[:, 0:2].permute(2, 0, 1)  # (S, 4, 2)
    x2 = quad[:, 2:4].permute(2, 0, 1)
    x1n, t1 = geometry.hartley_normalize(x1)
    x2n, t2 = geometry.hartley_normalize(x2)
    rows = geometry.dlt_rows(x1n, x2n).reshape(s, 8, 9).double()

    def to_h(h8):
        h = torch.cat([h8, torch.ones_like(h8[:, :1])], 1).reshape(s, 3, 3)
        return geometry._denormalize_h(h.float(), t1, t2)

    return rows[:, :, :8].contiguous(), -rows[:, :, 8:].contiguous(), to_h


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


def _captured_counts(run, s: int):
    """(Hs, x1, x2, valid, kind, thr) of the first K1 call of S=s
    hypotheses that run() makes on the card, taken as handed over."""
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


def _affine_fit(dev):
    """The affine one-point fit (tests/test_pipeline.py::TestAffinePath's
    scene: 300 points, 2 planes, ground-truth affines) at the default
    config: (run() -> FitResult, ground-truth labels, config)."""
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch import MultiHConfig
    from multih_tpu_torch.utils import data, features

    cs, Hs = data.synthetic_scene(300, 2, 0.1, 0.3, seed=21)
    aff = features.affines_from_homographies(Hs, cs.gt_labels - 1, cs.x1,
                                             outlier_label=-1)
    cfg = MultiHConfig(max_points=512)
    x1, x2, valid, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, 512)
    A = np.tile(np.eye(2, dtype=np.float32), (512, 1, 1))
    A[:cs.n_points] = aff
    args = _to(dev, x1, x2, valid, A)
    gen = torch.Generator(device=dev)

    def run(affines=True):
        return mt.fit(*args[:3], gen.manual_seed(0), cfg,
                      affines=args[3] if affines else None)
    run.args, run.gt, run.cfg = args, gt, cfg
    return run


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

    def count_rows(name, Hs, x1, x2, valid, kind, thr):
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
        count_rows("inlier_counts", Hs, x1[:n], x2[:n], valid[:n], kind,
                   thr)

    # K1's epipolar kinds at the motion fit's verify shape (2048
    # hypotheses + 3 claims x 512 points), F's solved from 8-point
    # samples of the fm4_a scene
    x1, x2, valid = _motion_points("fm4_a", 512, dev)
    n_valid = int(valid.sum())
    for kind in ("f_sampson", "f_symmetric", "f_transfer"):
        idx = torch.from_numpy(rng.integers(0, n_valid, (2051, 8))).to(dev)
        Fs = fmodel.fundamental_8pt_batch_qr(x1[idx], x2[idx]).contiguous()
        count_rows("inlier_counts_f", Fs, x1, x2, valid, kind, thr)

    # K1 at the mixed fit's stage verify shape (2048 hypotheses + 3
    # claims x 1024 points of mx21_a) in the two kinds its stages count:
    # H's from 4-point and F's from 8-point samples of its points
    x1, x2, valid = _suite_points(data.mixed_suite_scene("mx21_a"), 1024,
                                  dev)
    idx = torch.from_numpy(rng.integers(0, int(valid.sum()),
                                        (2051, 8))).to(dev)
    Hs = geometry.homography_4pt_batch_qr(x1[idx[:, :4]],
                                          x2[idx[:, :4]]).contiguous()
    count_rows("inlier_counts", Hs, x1, x2, valid, "symmetric", thr)
    Fs = fmodel.fundamental_8pt_batch_qr(x1[idx], x2[idx]).contiguous()
    count_rows("inlier_counts_f", Fs, x1, x2, valid, "f_sampson", thr)

    # K1 on the affine path's own verify pool: the 2048 sampled + 3
    # claim hypotheses and the 512 one-point H's (one a point, padded
    # points included: they are masked only after the count), with the
    # fit's points and threshold, as the affine fit hands them over
    pool = _captured_counts(_affine_fit(dev), 2051 + 512)
    hs = pool[0]
    print(f"  affine verify pool: {hs.shape[0]} hypotheses, "
          f"{int((~torch.isfinite(hs.reshape(-1, 9)).all(1)).sum())} of "
          f"them non-finite")
    count_rows("inlier_counts", *pool)

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
        # the library call: batched LU solves of the plain version's
        # (S, 8, 8) float64 systems (solve_ex: no host check of singular
        # ones), the denormalization outside the timed call
        a8, b8, to_h = _dlt_systems(gt)
        h_lib = to_h(torch.linalg.solve_ex(a8, b8)[0][..., 0])
        sign = torch.where((h_lib * hs).sum((1, 2)) < 0, -1.0, 1.0)
        e_lib = float((h_lib * sign[:, None, None] - hs).abs().amax(
            (1, 2))[well].max())
        print(f"  dlt S={s}: library call torch.linalg.solve_ex on the "
              f"(S, 8, 8) float64 systems, max abs err vs the kernel "
              f"{e_lib:.3g} on the well-conditioned usable quads")
        row = record("dlt_4pt", f"S={s} (32, S) rows", err,
                     lambda: dlt_kernel.homography_4pt_gt(gt),
                     lambda: dlt_kernel.homography_4pt_gt_reference(gt),
                     4 * 30 * s, (DLT_OPS + DLT_TEST_OPS) * s,
                     lib=lambda: torch.linalg.solve_ex(a8, b8))
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
    2 iterations) and the default config at N=1024 (L=17, B=256, as the
    batch and the direct-refit fits of phase 10 run it). K4 and K5 read the list the fit builds beside the band
    (its build is timed on its own); each call's CUDA launches are
    counted by torch.profiler. Bounds count the list's non-zeros: each
    pair (8 bytes) read once."""
    import torch

    from multih_tpu_torch.ops.kernels import mrf_kernel as mk

    sw = 0.1
    # the N=1024 default shape came last and draws from a generator of
    # its own: the kernels checked after this one keep their inputs
    for l, n_points, n, block, sweeps, icm_it, g in (
            (17, 500, 512, 256, 6, 2, rng),
            (17, 10000, 10240, 128, 4, 1, rng),
            (9, 1000, 1024, 256, 6, 2, rng),
            (17, 1000, 1024, 256, 6, 2, np.random.default_rng(1))):
        _, _, valid, _, adj = _windowed_problem(dev, n_points, n, block)
        dct = torch.from_numpy(g.uniform(0, 2.0, (l, n)).astype(
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
            torch.from_numpy(g.integers(0, l, n)).to(dev),
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
    on the fit's own tensors (x1, x2, valid, the band's degree, Hs,
    active), thr a device tensor: one CUDA launch a call; r to rtol 1e-3
    / atol 1e-4 of the plain version's up to 1e6 px^2 (saturated past
    it) and min(r/thr, 8) to atol 1e-4 everywhere; r (relative, up to
    1e6 px^2) and min(r/thr, 8) each within 8x the plain version's own
    distance from the float64 residuals of the same float32 inputs (the
    kernel rounds each term, the plain version's matmul fuses: over
    tools/torch_float_floor.py's 8 draws at the stress shape the
    kernel's distance reached 3.4x (r) and 5.0x (cost) the plain one's,
    on this phase's draws 2.0x and 1.0x); dct equal to
    data_costs_t of the kernel's own r (rtol 2e-6); q equal to K4's on
    the kernel's own base dct + sw*deg bit for bit (the same sweep code)
    and within 1e-4 of the plain version (its max_abs_err). 15
    near-identity planes, one inactive, and a wild one whose residuals
    reach the truncation; the scene's own points."""
    import torch

    from multih_tpu_torch.models import labeling
    from multih_tpu_torch.ops import geometry
    from multih_tpu_torch.ops.kernels import mrf_kernel as mk

    l, sw = 17, 0.1
    k = l - 1
    for n_points, n, block, sweeps in ((500, 512, 256, 6),
                                       (10000, 10240, 128, 4)):
        x1, x2, valid, _, adj = _windowed_problem(dev, n_points, n, block)
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
        nnz = int((adj.band != 0).sum())
        shape = f"L={l} N={n} B={block}"
        for kind in ("symmetric", "transfer"):
            args = (q0, x1, x2, valid, adj.deg, hs, active, adj.band, inv_t,
                    thr, sw, 1.0, kind)

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
            # float64 residuals of the same float32 inputs: each float32
            # version's distance from them
            r64 = geometry.residual_matrix(hs.double(), x1.double(),
                                           x2.double(), kind)
            near64 = r64 <= 1e6
            c64 = torch.clamp_max(r64 / 9.0, 8.0)
            d_r = [float(((a.double() - r64).abs()
                          / r64.abs().clamp_min(1e-4))[near64].max())
                   for a in (r, r_ref)]
            d_c = [float((torch.clamp_max(a.double() / 9.0, 8.0)
                          - c64).abs().max()) for a in (r, r_ref)]
            check(d_r[0] <= 8.0 * d_r[1] and d_c[0] <= 8.0 * d_c[1],
                  f"fused front {shape} {kind}: from float64, r (relative) "
                  f"{d_r[0]:.3g} against the plain version's {d_r[1]:.3g}, "
                  f"min(r/thr, 8) {d_c[0]:.3g} against {d_c[1]:.3g}")
            # q: K4's sweeps on the kernel's own base, bit for bit; 1e-4
            # of the plain version end to end, where r's last-bit
            # differences (px - u cancels) reach q through 1/T up to 4
            err = float((q - q_ref).abs().max())
            q4 = mk.mean_field_fused(q0, (dct + sw * adj.deg.T).contiguous(),
                                     adj.band, inv_t, sw, nbr=adj.nbr)
            check(bool(torch.isfinite(q).all()) and torch.equal(q, q4)
                  and err <= 1e-4, f"fused front {shape} {kind}: q equal to "
                  f"K4's on its own base: {torch.equal(q, q4)}; max abs "
                  f"err {err} (plain version)")
            rel = (r - r_ref).abs() / r_ref.abs().clamp_min(1e-4)
            print(f"  front {shape} {kind}: q equal to K4's on its own "
                  f"base; r max rel err {float(rel[near].max()):.3g} up to "
                  f"1e6 px^2, {float(rel.max()):.3g} over all; "
                  f"{int((~near).sum())} of {r.numel()} residuals past "
                  f"1e6 px^2, max {float(r.max()):.3g}; from float64: r "
                  f"(relative, up to 1e6 px^2) kernel {d_r[0]:.3g}, plain "
                  f"{d_r[1]:.3g}; min(r/thr, 8) kernel {d_c[0]:.3g}, plain "
                  f"{d_c[1]:.3g}")
            # inputs q0, x1, x2 (N, 2), valid, deg (N,), Hs (K, 3, 3),
            # active (K,), the list's pairs and counts, inv_temps, thr read
            # once; q, dct (L, N) and r (K, N) written once
            n_bytes = (8 * nnz + 4 * n
                       + 4 * (l * n + 6 * n + 10 * k + sweeps + 1)
                       + 4 * (2 * l * n + k * n))
            n_ops = (sweeps * (2 * nnz * l + 8 * l * n)
                     + FRONT_OPS[kind] * k * n + 3 * n
                     + (27 * k if kind == "symmetric" else 0))
            row = record("mean_field_fused_front", f"{shape} "
                         f"sweeps={sweeps} {kind}", err, kernel, plain,
                         n_bytes, n_ops)
            n_launch, launched = cuda_launches(kernel)
            check(n_launch in (1, None), f"fused front {shape}: launches "
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


def phase_surfaces(dev):
    """The batch surface, the affine one-point pool, the direct refit and
    the CLI: run_benchmark_batch on the 24 homography golden scenes padded
    to max_points 1024 at the default config with the golden taus (each
    pair >= 97% in agreement with its golden labels and equal to its
    single fit on the card with the same generator), the batch's wall
    time against the sum of the pairs' warm single fits and its device
    busy time a pair over every 4th pair (an estimate of the idle share); the affine fit (tests/test_pipeline.py::TestAffinePath's
    scene at the default config: 2 planes, error < 3%) and its one-point
    pool against the CPU's; the direct-refit fit (refit_moments=False)
    on BASELINE config 2 (exact recovery); `multih_tpu_torch.cli synth
    --json` as a subprocess. Each fit path is one entry of the launch
    counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import multih_tpu_torch as mt
    from multih_tpu_torch import MultiHConfig
    from multih_tpu_torch.ops import epipolar
    from multih_tpu_torch.parallel import sharding
    from multih_tpu_torch.utils import data, evaluation

    print("== 10. the batch surface, the affine pool, the direct refit and "
          "the CLI")
    t_start = time.perf_counter()
    out, launches = {}, {}
    kernels_h = ("inlier_counts", "dlt_4pt", "eig9_smallest",
                 "mean_field_fused", "icm_fused", "band_list")

    # the batch: 24 golden scenes at N=1024, one upload, golden taus
    cfg = MultiHConfig(max_points=1024)
    css = [data.suite_scene(row[0]) for row in data.SUITE]
    goldens = [np.load(os.path.join(ROOT, "tests", "goldens",
                                    f"{cs.name}.npz")) for cs in css]
    taus = [float(g["inlier_threshold"]) for g in goldens]
    prepared = sharding.prepare_benchmark_batch(css, cfg, taus=taus,
                                                device=dev)
    (x1, x2, valid, t), b = prepared

    def batch():
        return sharding.run_benchmark_batch(css, cfg, seed=0,
                                            prepared=prepared)

    res, launches["batch"] = count_launches("batch (24 pairs)", kernels_h,
                                            batch)
    batch_res = res
    check(res.labels.shape == (24, 1024), f"batch labels {res.labels.shape}")
    rows = []
    for i, (cs, g) in enumerate(zip(css, goldens)):
        lab = res.labels[i][:cs.n_points]
        agree = 100.0 - evaluation.misclassification_error(
            lab, g["labels"], cfg.max_labels,
            gt_outlier=int(g["outlier_label"]))
        err = evaluation.misclassification_error(lab, cs.gt_labels,
                                                 cfg.max_labels)
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
                         misclassification=err, equals_single=same,
                         h_max_diff_single=h_diff))
        print(f"batch pair {i:2d} {cs.name:12s} tau {taus[i]:.1f}: planes "
              f"{rows[-1]['planes']} (golden {rows[-1]['golden_planes']}), "
              f"agreement with the golden labels {agree:.2f}%, "
              f"misclassification {err:.3f}%, equal to its single fit "
              f"{same} (H max diff {h_diff:.3g})")
        check(agree >= 97.0, f"batch {cs.name}: agreement {agree:.2f}%")
        check(same, f"batch {cs.name}: not its single fit")
    out["pairs"] = rows
    print(f"batch: mean agreement "
          f"{statistics.mean(r['agreement'] for r in rows):.3f}%, all 24 "
          f"equal to their single fits")

    # wall time: the batch against the sum of the pairs' warm single fits
    # (each ending in a synchronize), in turns
    gens = [torch.Generator(device=dev) for _ in range(b)]

    def singles():
        return sum(host_ms(lambda: mt.fit(x1[i], x2[i], valid[i],
                                          gens[i].manual_seed(i), cfg,
                                          tau=t[i]), reps=1)[0]
                   for i in range(b))

    t_batch, t_singles = [], []
    for _ in range(3):
        t_batch += host_ms(batch, reps=1)
        t_singles.append(singles())
    # device busy time a pair, torch.profiler over a batch of every 4th
    # pair (6 spread across the suite: easy2_a, med3_b, hard5_a,
    # outlier50_a, noisy_a, overlap4_a; the profile of all 24 takes
    # minutes to read). The idle share is an
    # estimate: that sample's busy time a pair x 24 over the median wall
    # time of the unprofiled 24-pair runs
    sample = list(range(0, b, 4))
    part = sharding.prepare_benchmark_batch(
        [css[i] for i in sample], cfg, taus=[taus[i] for i in sample],
        device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sharding.run_benchmark_batch([css[i] for i in sample], cfg,
                                     prepared=part)
        torch.cuda.synchronize()
    busy = busy_us(prof.key_averages()) / 1e3 / len(sample)
    wall = statistics.median(t_batch)
    out["wall"] = dict(batch_ms=t_batch, sum_single_ms=t_singles,
                       ratio=wall / statistics.median(t_singles),
                       busy_ms_per_pair_sampled=busy,
                       busy_sample=[css[i].name for i in sample],
                       idle_share_estimated=1.0 - busy * b / wall)
    print(f"batch of {b} pairs at N=1024: wall {wall:.1f} ms (runs "
          f"{', '.join(f'{v:.1f}' for v in t_batch)}) against the sum of "
          f"its warm single fits {statistics.median(t_singles):.1f} ms "
          f"(runs {', '.join(f'{v:.1f}' for v in t_singles)}): ratio "
          f"{out['wall']['ratio']:.3f}; {wall / b:.2f} ms a pair; device "
          f"busy {busy:.2f} ms a pair over a profile of "
          f"{', '.join(out['wall']['busy_sample'])}, idle share estimated "
          f"from it {out['wall']['idle_share_estimated']:.3f} "
          f"[{card_line()}]")
    print(f"phase 10 batch part: {time.perf_counter() - t_start:.1f} s")

    # the affine one-point pool at the default config
    affine_fit = _affine_fit(dev)
    aargs, acfg = affine_fit.args, affine_fit.cfg
    ares, launches["affine"] = count_launches("affine", kernels_h, affine_fit)
    aerr = evaluation.misclassification_error(ares.labels.cpu().numpy(),
                                              affine_fit.gt, acfg.max_labels)
    a_ms = host_ms(affine_fit, reps=5)
    plain_ms = host_ms(lambda: affine_fit(affines=False), reps=5)
    F = epipolar.estimate_fundamental(_cpu_draws(0), *aargs[:3])
    pool_gpu = epipolar.homography_one_point_batch(F, *aargs[:2], aargs[3])
    pool_cpu = epipolar.homography_one_point_batch(
        F.cpu(), *[a.cpu() for a in aargs[:2]], aargs[3].cpu())
    live = (aargs[2] > 0).cpu().numpy()
    pool_diff = float((pool_gpu.cpu() - pool_cpu).abs().numpy()[live].max())
    out["affine"] = dict(planes=int(ares.active.sum()), misclassification=aerr,
                         warm_ms=a_ms, warm_ms_without_affines=plain_ms,
                         pool_card_vs_cpu=pool_diff,
                         n_hypotheses_ok=float(ares.n_hypotheses_ok))
    print(f"affine fit, 300 points: planes {out['affine']['planes']}, "
          f"misclassification {aerr:.3f}%, pool {float(ares.n_hypotheses_ok)}"
          f" hypotheses; warm ms {statistics.median(a_ms):.1f} (without "
          f"affines {statistics.median(plain_ms):.1f}); one-point pool on "
          f"the card vs the CPU on one F: max diff {pool_diff:.3g}")
    check(out["affine"]["planes"] == 2 and aerr < 3.0,
          f"affine fit: {out['affine']}")
    check(bool(torch.isfinite(pool_gpu).all()), "non-finite one-point H")

    # the direct refit: BASELINE config 2, exact recovery
    dcfg = MultiHConfig(max_points=1024, refit_moments=False)
    gen = torch.Generator(device=dev)
    (planes, err), launches["direct_refit"] = count_launches(
        "direct-refit", ("inlier_counts", "dlt_4pt", "mean_field_fused",
                         "icm_fused", "band_list"),
        lambda: _baseline2(dev, dcfg, gen))
    # warm latency of the direct and the moment refit on BASELINE config
    # 2, one fit of each in turns
    times = {"direct": [], "moments": []}
    for _ in range(5):
        for label, c in (("direct", dcfg), ("moments", cfg)):
            times[label] += host_ms(lambda: _baseline2(dev, c, gen), reps=1)
    out["direct_refit"] = dict(planes=planes, misclassification=err,
                               warm_ms=times["direct"],
                               warm_ms_moments=times["moments"])
    print(f"direct refit, BASELINE config 2: planes {planes}, "
          f"misclassification {err:.4f}%, warm median "
          f"{statistics.median(times['direct']):.1f} ms against "
          f"{statistics.median(times['moments']):.1f} ms for the moment "
          f"refit (5 each, in turns; K3 launches "
          f"{launches['direct_refit']['eig9_smallest']}: its refits solve "
          f"with eigh)")
    check(planes == 2 and err == 0.0, "direct refit: BASELINE config 2 not "
          "recovered exactly")

    # the CLI, a process of its own on the card
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "multih_tpu_torch.cli", "synth", "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli synth failed: {proc.stderr[-2000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    out["cli"] = dict(seconds=cli_s, **{k: cli[k] for k in (
        "n_planes_found", "misclassification_pct", "time_total_s",
        "time_warm_s")})
    print(f"cli synth --json: {cli_s:.1f} s in all, planes "
          f"{cli['n_planes_found']}, misclassification "
          f"{cli['misclassification_pct']:.3f}%, first fit "
          f"{cli['time_total_s']} s, warm fit {cli['time_warm_s']} s")
    print(f"phase 10: {time.perf_counter() - t_start:.1f} s")
    check(cli["n_planes_found"] == 2 and cli["misclassification_pct"] < 5.0,
          f"cli synth: {cli}")
    return out, launches, batch_res


# ---------------------------------------------------------------------------
# phase 11: the mesh axes
# ---------------------------------------------------------------------------

MESH_KERNELS = ("inlier_counts", "dlt_4pt", "window_gather")


def _stress_points(device):
    """Phase 5's stress scene (10k points, 8 planes, 70% outliers) padded
    to 10240, on `device`."""
    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import data

    cs, _ = data.synthetic_scene(10000, 8, 0.7, 0.5, seed=42)
    return _to(device, *mt.pad_points(cs.x1, cs.x2, None, 10240))


def _hv_inputs(cfg, x1, x2, valid):
    """The Morton-sorted points and sampling graph that fit() hands its
    hypothesize + verify stages on the windowed path (stress config:
    the windowed graph of positions and 2x motion)."""
    import torch

    from multih_tpu_torch.models import labeling, pipeline

    perm = pipeline.morton_order(x1, valid)
    x1, x2, valid = x1[perm], x2[perm], valid[perm]
    feat = torch.cat([x1, cfg.sampling_motion_weight * (x2 - x1)], dim=1)
    nbr, _ = labeling.knn_graph_windowed(feat, valid, cfg.knn_k,
                                         cfg.agree_block)
    return x1, x2, valid, nbr


def _traced_device_ms(fn, trace_dir: str, worker: str) -> dict:
    """Device ms of one warm call of fn, read by utils/tracing.py from
    the torch.profiler trace that tensorboard_trace_handler writes: all
    its kernels, and the NCCL kernels among them (which spin on the card
    until every peer has arrived). A session that came back with no
    device events is taken again, up to 5 times."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    from multih_tpu_torch.utils import tracing

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        d = os.path.join(trace_dir, f"{worker}-{attempt}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     on_trace_ready=tensorboard_trace_handler(
                         d, worker_name=worker)):
            fn()
            torch.cuda.synchronize()
        times = tracing.module_device_times_ms(d, min_ms=0.0)
        if times:
            nccl = tracing.module_device_times_ms(d, 0.0, "nccl")
            return dict(all_ms=sum(times), kernels=len(times),
                        nccl_ms=sum(nccl), nccl_kernels=len(nccl))
    check(False, f"{worker}: the trace held no device kernel")


def _golden_batch():
    """The 24 golden scenes and their taus (phase 10's batch)."""
    from multih_tpu_torch.utils import data

    css = [data.suite_scene(row[0]) for row in data.SUITE]
    taus = [float(np.load(os.path.join(ROOT, "tests", "goldens",
                                       f"{cs.name}.npz"))["inlier_threshold"])
            for cs in css]
    return css, taus


def _mesh_rank(rank, device, trace_dir):
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
    args = _stress_points(device)
    f = sharding.hyp_sharded_fit(cfg, hyp)
    hyp.host_staged = 0
    res, launches["mesh_stress"] = count_launches(
        f"mesh stress rank {rank}", MESH_KERNELS,
        lambda: f(*args, gen.manual_seed(0)), quiet=True)
    out["stress"] = fit_out(res)
    out["stress_staged_bytes"] = hyp.host_staged
    out["stress_warm_ms"] = host_ms(lambda: f(*args, gen.manual_seed(0)),
                                    reps=3)
    xs = _hv_inputs(cfg, *args)

    def hv():
        return pipeline._hypothesize_verify_sharded(
            TorchDraws(gen.manual_seed(0)), *xs, cfg, None, hyp,
            window_block=cfg.agree_block)

    out["hv_cand"] = hv()[1].cpu().numpy()
    out["hv"] = _traced_device_ms(hv, trace_dir, f"rank{rank}")

    # (b) the motion fit on fm4_a, hyp-sharded
    mcfg = motion_cfg(512)
    margs = _motion_points("fm4_a", 512, device)
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
        replicated=float(ok),
        sharded_ms=host_ms(lambda: verify(Hs, *xs[:3]), reps=3),
        single_ms=host_ms(lambda: top_k_stable(pipeline.count_inliers(
            Hs, *xs[:3], cfg), cfg.n_candidates), reps=3))

    # (d) the 24 golden scenes on a (2, 1) mesh: 12 pairs a rank
    bcfg = mt.MultiHConfig(max_points=1024)
    css, taus = _golden_batch()
    prepared = sharding.prepare_benchmark_batch(css, bcfg, taus=taus,
                                                mesh=pair)
    pair.host_staged = 0
    bres, launches["mesh_batch"] = count_launches(
        f"mesh batch rank {rank}", ("inlier_counts", "dlt_4pt"),
        lambda: sharding.run_benchmark_batch(css, bcfg, seed=0,
                                             prepared=prepared, mesh=pair),
        quiet=True)
    out["batch"] = bres._asdict()
    out["batch_staged_bytes"] = pair.host_staged
    out["batch_ms"] = host_ms(lambda: sharding.run_benchmark_batch(
        css, bcfg, seed=0, prepared=prepared, mesh=pair), reps=2)
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
    xs = _hv_inputs(cfg, *_stress_points(device))
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
    tensors through the host, counted), then one NCCL rank. Each rank's
    results against this process's single-device fits on the card."""
    import tempfile

    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.models import pipeline
    from multih_tpu_torch.ops.sampling import TorchDraws
    from multih_tpu_torch.parallel import mesh

    print("== 11. the mesh: a (1, 2) and a (2, 1) mesh of two gloo ranks "
          "on the one card, and a one-rank NCCL mesh")
    t_start = time.perf_counter()
    out = {}
    gen = torch.Generator(device=dev)
    cfg = stress_cfg()
    args = _stress_points(dev)
    ref = mt.fit(*args, gen.manual_seed(0), cfg)
    single_warm = host_ms(lambda: mt.fit(*args, gen.manual_seed(0), cfg),
                          reps=3)
    xs = _hv_inputs(cfg, *args)

    def hv():
        return pipeline._hypothesize_verify(
            TorchDraws(gen.manual_seed(0)), *xs, cfg, None, [], [],
            cfg.agree_block)

    ref_cand = hv()[0].cpu().numpy()
    mcfg = motion_cfg(512)
    mref = mt.fit(*_motion_points("fm4_a", 512, dev), gen.manual_seed(0),
                  mcfg)
    with tempfile.TemporaryDirectory() as tmp:
        single_hv = _traced_device_ms(hv, tmp, "single")
        t0 = time.perf_counter()
        ranks = mesh.spawn(_mesh_rank, 2, "gloo", lambda r: "cuda:0",
                           timeout_s=400.0, args=(tmp,))
        t_gloo = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = mesh.spawn(_nccl_rank, 1, "nccl", lambda r: "cuda:0",
                      timeout_s=180.0)[0]
    t_nccl = time.perf_counter() - t0
    launches = {}
    for r, got in enumerate(ranks):
        for label, want, model in (("stress", ref, cfg),
                                   ("motion", mref, mcfg)):
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
              f"{v['replicated']}; warm ms sharded "
              f"{', '.join(f'{x:.2f}' for x in v['sharded_ms'])}, single "
              f"{', '.join(f'{x:.2f}' for x in v['single_ms'])}")
        check(v["equal"] and v["replicated"] == 1.0,
              f"rank {r}: sharded verification {v}")
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
        print(f"rank {r} hypothesize + verify device ms (utils/tracing.py): "
              f"{got['hv']['all_ms']:.4f} over {got['hv']['kernels']} "
              f"kernels; "
              f"host-staged bytes: stress fit {got['stress_staged_bytes']}, "
              f"batch {got['batch_staged_bytes']}")
    check(all(np.array_equal(ranks[0]["batch"][k], ranks[1]["batch"][k])
              for k in ranks[0]["batch"]), "the ranks' batches differ")
    print(f"single-process hypothesize + verify device ms "
          f"(utils/tracing.py): {single_hv['all_ms']:.4f} over "
          f"{single_hv['kernels']} kernels [{card_line()}]")
    print(f"stress warm wall ms, (1, 2) mesh on one card, rank 0: "
          f"{', '.join(f'{x:.1f}' for x in ranks[0]['stress_warm_ms'])}; "
          f"single process: {', '.join(f'{x:.1f}' for x in single_warm)}")
    print(f"24-pair batch wall ms on the (2, 1) mesh, rank 0: "
          f"{', '.join(f'{x:.1f}' for x in ranks[0]['batch_ms'])}; all 24 "
          f"pairs equal to phase 10's batch on both ranks")
    print(f"NCCL one-rank mesh {nccl['shape']} ({nccl['backend']}): "
          f"sharded_verification equal {nccl['equal']}, replicated "
          f"{nccl['replicated']}, host-staged bytes {nccl['staged']}")
    check(nccl["equal"] and nccl["replicated"] == 1.0
          and nccl["staged"] == 0, f"NCCL mesh: {nccl}")
    print(f"phase 11: {time.perf_counter() - t_start:.1f} s (gloo ranks "
          f"{t_gloo:.1f} s, NCCL rank {t_nccl:.1f} s)")
    out = dict(
        single=dict(stress_warm_ms=single_warm, hv=single_hv),
        ranks=[dict(stress_warm_ms=g["stress_warm_ms"], hv=g["hv"],
                    stress_staged_bytes=g["stress_staged_bytes"],
                    batch_staged_bytes=g["batch_staged_bytes"],
                    batch_ms=g["batch_ms"], verify=g["verify"],
                    launches=g["launches"]) for g in ranks],
        nccl=nccl, seconds=dict(gloo=t_gloo, nccl=t_nccl))
    return out, launches


PT_KERNELS = ("inlier_counts", "eig9_smallest", "mean_field_fused",
              "icm_fused")


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
                   :144-148) at the golden tau, N = 512, phase 6's CPU
                   key 0, held to the motion bound;
      motion_full  the F model at full width: 10000 points, 4 motions,
                   30% outliers, N = 10240 at agree_block 128 (40 blocks
                   a rank), the motion suite's config otherwise;
      exact        BASELINE config 2 at the side config (the exact graph,
                   whose far edges a sweep gathers; no K4 or K5)."""
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
         data.motion_suite_scene("fm4_a"), lambda: _cpu_draws(0),
         float(g["misclassification"])),
        ("motion_full", 10240,
         dataclasses.replace(motion_cfg(10240), agree_block=128),
         data.synthetic_motion_scene(10000, 4, 0.3, 0.5, seed=42)[0],
         cuda_key, None),
        ("exact", 1024, _slice_cfg(max_points=1024), baseline2, cuda_key,
         None),
    )
    out = []
    for name, n_pad, cfg, scene, key, golden in rows:
        x1, x2, valid, gt = mt.pad_points(scene.x1, scene.x2,
                                          scene.gt_labels, n_pad)
        out.append(dict(name=name, cfg=cfg, args=_to(device, x1, x2, valid),
                        gt=gt, key=key, golden=golden))
    return out


def _pt_expected(cfg, single: dict) -> dict:
    """Each kernel's launches in one 'pt' rank's fit, from the single
    card fit's (`single`): K4 a launch a mean-field sweep and K5 one an
    ICM half-sweep where the single fit launches each once a call (none
    on the exact graph's band, in either), every other kernel as often
    as in the single fit (the refits gather their weights and refit
    whole; each rank counts its own points, once a sweep)."""
    factor = {"mean_field_fused": cfg.meanfield_iterations,
              "icm_fused": 2 * cfg.icm_iterations}
    return {k: n * factor.get(k, 1) for k, n in single.items()}


def _pt_sweep_inputs(device):
    """K4's and K5's inputs at the stress shape (N = 10240, B = 128,
    L = 17, 2 starts, 4 sweeps, 1 ICM iteration), from a generator of
    their own: the stress scene's Morton-sorted positions and valid mask,
    q0 softmax rows, base, int32 starts, inverse temperatures."""
    import torch

    from multih_tpu_torch.models import pipeline

    x1, _, valid = _stress_points(device)
    perm = pipeline.morton_order(x1, valid)
    rng = np.random.default_rng(1212)
    base = rng.uniform(0.0, 4.0, (17, 10240)).astype(np.float32)
    q0 = np.exp(-base)
    q0 /= q0.sum(0)
    starts = rng.integers(0, 17, (2, 10240), dtype=np.int32)
    inv_t = (1.0 / np.geomspace(3.0, 0.5, 4)).astype(np.float32)
    return (x1[perm], valid[perm], *_to(device, q0, base, starts, inv_t))


def _pt_graphs(cfg, x1, x2, valid, mesh=None):
    """The fit's two k-NN graphs (positions; the sampling features), the
    windowed or the exact one as the fit builds it, on the Morton-sorted
    points as numpy: every row, or with `mesh` a 'pt' rank's own rows.
    With `mesh`, also the rank's band as the fit builds it
    (labeling.shard_adjacency) and the host-staged bytes of one sweep's
    agreement on it (the halo exchange, and on the exact graph the
    gather of the far columns), with the far columns a rank sends."""
    import torch

    from multih_tpu_torch.models import labeling, pipeline

    perm = pipeline.morton_order(x1, valid)
    x1, x2, valid = x1[perm], x2[perm], valid[perm]
    windowed = pipeline.graph_path(cfg, x1.shape[0]) == "windowed"
    shard = rows = None
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
    nbr, w = graph(x1)
    graphs = [nbr.cpu().numpy(), graph(feat)[0].cpu().numpy()]
    if shard is None:
        return graphs, None
    labeling.shard_adjacency(nbr, w, shard, windowed)
    q = torch.zeros((cfg.max_labels + 1, shard.n_own), device=x1.device)
    staged = mesh.host_staged
    shard.agree_t(q)
    return graphs, dict(
        bytes=mesh.host_staged - staged,
        far_cols=0 if shard.far is None else int(shard.far.send.shape[0]))


def _pt_rank(rank, device):
    """One of phase 12's two gloo ranks on the one card: each cell's fit
    on a (pt=2) mesh (its launches, host-staged bytes, peak memory and
    warm walls, and the bytes of one sweep's agreement), then K4 and K5
    on the rank's window at the stress shape, a launch a sweep with the
    halo exchanged between launches."""
    import torch

    from multih_tpu_torch.models import labeling
    from multih_tpu_torch.ops.kernels import mrf_kernel
    from multih_tpu_torch.parallel import sharding

    m = sharding.make_pt_mesh(device=device)
    out = {}
    for c in _pt_cells(device):
        name, args, key = c["name"], c["args"], c["key"]
        out[f"{name}_graphs"], sweep = _pt_graphs(c["cfg"], *args, m)
        f = sharding.pt_sharded_fit(c["cfg"], m)
        f(*args, key())  # warm: the library loads once
        m.host_staged = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        res, launches = count_launches(
            f"pt {name} rank {rank}", (), lambda: f(*args, key()),
            quiet=True)
        out[name] = dict(
            labels=res.labels.cpu().numpy(), active=res.active.cpu().numpy(),
            energy=float(res.energy), launches=launches,
            n_far_dropped=int(res.n_far_dropped),
            staged_bytes=m.host_staged, sweep=sweep,
            peak_bytes=torch.cuda.max_memory_allocated(device),
            warm_ms=host_ms(lambda: f(*args, key()), reps=3))

    x1, valid, q0, base, starts, inv_t = _pt_sweep_inputs(device)
    shard = labeling.PointShard(m, 10240, 128)
    nbr, w = labeling.knn_graph_windowed(x1, valid, 6, 128,
                                         (shard.lo, shard.hi))
    adj = labeling.build_window_adjacency(nbr, w, shard)
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
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.models import labeling
    from multih_tpu_torch.ops import geometry
    from multih_tpu_torch.ops.kernels import mrf_kernel
    from multih_tpu_torch.parallel import mesh
    from multih_tpu_torch.utils import evaluation

    print("== 12. the 'pt' (point) axis: a (pt=2) mesh of two gloo ranks "
          "on the one card; BASELINE config 2 (N=1024), the stress cell "
          "(N=10240), the F model on fm4_a (N=512) and at full width "
          "(N=10240), and BASELINE config 2 on the exact graph")
    t_start = time.perf_counter()
    single = {}
    for c in _pt_cells(dev):
        name, cfg, args, key = c["name"], c["cfg"], c["args"], c["key"]
        mt.fit(*args, key(), cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ref, launches = count_launches(f"single {name}", (),
                                       lambda: mt.fit(*args, key(), cfg),
                                       quiet=True)
        torch.cuda.synchronize()
        single[name] = dict(
            c, ref=ref, launches=launches,
            peak_bytes=torch.cuda.max_memory_allocated(dev),
            warm_ms=host_ms(lambda: mt.fit(*args, key(), cfg), reps=3))
    # why a 'pt' refit gathers its weights in their own layout: the
    # moment GEMM's float32 sums follow the operand's layout
    x1s, x2s, _ = _stress_points(dev)
    feats = geometry.prepare_refit(x1s, x2s).feats
    gen = torch.Generator(device=dev)
    wt = torch.rand((10240, 16), device=dev, generator=gen.manual_seed(0))
    d = float((wt.T @ feats - wt.T.contiguous() @ feats).abs().max())
    print(f"moment GEMM at the stress shape (16 x 10240 weights): a "
          f"transposed view against its contiguous copy, max |diff| {d:.3g}")
    x1, valid, q0, base, starts, inv_t = _pt_sweep_inputs(dev)
    nbr, w = labeling.knn_graph_windowed(x1, valid, 6, 128)
    adj = labeling.build_banded_adjacency(nbr, w, 128, far_capacity=0)
    q_full = mrf_kernel.mean_field_fused(q0, base, adj.band, inv_t, 0.7,
                                         nbr=adj.nbr).cpu().numpy()
    lab_full = mrf_kernel.icm_fused(starts, base, adj.band, 1, 0.7,
                                    nbr=adj.nbr).cpu().numpy()
    t0 = time.perf_counter()
    ranks = mesh.spawn(_pt_rank, 2, "gloo", lambda r: "cuda:0",
                       timeout_s=900.0)
    t_gloo = time.perf_counter() - t0
    out, launches = {"cells": {}, "moment_gemm_layout_diff": d}, {}
    for name, s in single.items():
        ref, cfg = s["ref"], s["cfg"]
        want = _pt_expected(cfg, s["launches"])
        graphs, _ = _pt_graphs(cfg, *s["args"])
        n_own = cfg.max_points // 2
        k1 = ("inlier_counts_f" if cfg.model == "fundamental"
              else "inlier_counts")
        cell = dict(single_warm_ms=s["warm_ms"],
                    single_peak_bytes=s["peak_bytes"],
                    single_launches=s["launches"], ranks=[])
        for r, got in enumerate(ranks):
            g = got[name]
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
            lc, sw = g["launches"], g["sweep"]
            print(f"rank {r} {name}: k-NN rows (both graphs) equal to the "
                  f"unsharded rows {graph_eq}; labels equal to the single "
                  f"card fit {lab_eq} ({n_diff} of {cfg.max_points} "
                  f"differ), active equal {act_eq}, n_far_dropped "
                  f"{g['n_far_dropped']} (single {int(ref.n_far_dropped)}),"
                  f" energy rel. gap {gap:.3g}, models "
                  f"{int(g['active'].sum())}, misclassification "
                  f"{err:.3f}%; launches K1 {lc[k1]} (single "
                  f"{s['launches'][k1]}), K3 {lc['eig9_smallest']} (single "
                  f"{s['launches']['eig9_smallest']}), K4 "
                  f"{lc['mean_field_fused']} (single "
                  f"{s['launches']['mean_field_fused']}), K5 "
                  f"{lc['icm_fused']} (single {s['launches']['icm_fused']}),"
                  f" list {lc['band_list']}; host-staged bytes a fit "
                  f"{g['staged_bytes']}, a sweep's agreement {sw['bytes']} "
                  f"(far columns a rank {sw['far_cols']}); peak allocated "
                  f"{g['peak_bytes'] / 2**20:.1f} MiB (single "
                  f"{s['peak_bytes'] / 2**20:.1f} MiB); warm wall ms "
                  f"{', '.join(f'{x:.1f}' for x in g['warm_ms'])} (single "
                  f"{', '.join(f'{x:.1f}' for x in s['warm_ms'])})")
            check(graph_eq and lab_eq and act_eq and drop_eq,
                  f"rank {r} {name}: {n_diff} labels differ, active "
                  f"{act_eq}, graph {graph_eq}, n_far_dropped {drop_eq}")
            check(gap <= 1e-3, f"rank {r} {name}: energy gap {gap:.3g}")
            check(lc == want, f"rank {r} {name}: launches {lc}, expected "
                  f"{want} (the single fit's, K4 a launch a sweep, K5 one "
                  f"a half-sweep)")
            # no K4 or K5 on the exact graph's band (far edges)
            for k in ((k1, "eig9_smallest", "mean_field_fused", "icm_fused")
                      if cfg.knn_window else (k1, "eig9_smallest")):
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
                misclassification=err, launches=lc,
                staged_bytes=g["staged_bytes"], sweep=sw,
                peak_bytes=g["peak_bytes"], warm_ms=g["warm_ms"]))
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
    out["seconds"] = dict(gloo=t_gloo, phase=time.perf_counter() - t_start)
    print(f"phase 12: {out['seconds']['phase']:.1f} s (gloo ranks "
          f"{t_gloo:.1f} s) [{card_line()}]")
    return out, launches


def _dryrun_rank(rank, device):
    """One of phase 13's gloo ranks: tools/torch_dryrun_multichip.py's
    rank function, its kernel launches counted."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_dryrun_multichip as dryrun

    return count_launches(
        f"dryrun rank {rank}", ("inlier_counts", "inlier_counts_f",
                                "dlt_4pt", "eig9_smallest",
                                "mean_field_fused", "icm_fused",
                                "band_list"),
        lambda: dryrun.dryrun_rank(rank, device, 2), quiet=True)


def phase_dryrun():
    """Phase 13: the port's dryrun_multichip (tools/torch_dryrun_multichip
    .py) on two gloo ranks sharing the card: every mesh path at the
    reference's tiny shapes, asserted on known labels in the ranks."""
    from multih_tpu_torch.parallel import mesh

    print("== 13. dryrun_multichip: every mesh path on two gloo ranks on "
          "the one card")
    t0 = time.perf_counter()
    ranks = mesh.spawn(_dryrun_rank, 2, "gloo", lambda r: "cuda:0",
                       timeout_s=600.0)
    res = [r[0] for r in ranks]
    for r, got in enumerate(res):
        check(got == res[0], f"dryrun rank {r}: {got}, rank 0 {res[0]}")
    seconds = time.perf_counter() - t0
    print(f"dryrun_multichip OK on 2 gloo ranks: {res[0]}; launches by "
          f"rank {[r[1] for r in ranks]}; {seconds:.1f} s [{card_line()}]")
    launches = {f"dryrun_r{r}": lc for r, (_, lc) in enumerate(ranks)}
    return dict(res[0], seconds=seconds), launches


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


def _aot_cases(dev):
    """Phase 14's cells: (label, cfg, kind, (x1, x2, valid), extra,
    kernels the replay must launch, timed)."""
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch import MultiHConfig
    from multih_tpu_torch.utils import data, streaming

    easy = _suite_points(data.suite_scene("easy2_a"), 512, dev)
    tau = float(np.load(os.path.join(ROOT, "tests", "goldens",
                                     "easy2_a.npz"))["inlier_threshold"])
    cs, _ = data.synthetic_scene(1000, 2, 0.0, 0.0)
    base2 = _to(dev, *mt.pad_points(cs.x1, cs.x2, None, 1024))
    cs, _ = data.synthetic_scene(10000, 8, 0.7, 0.5, seed=42)
    stress = _to(dev, *mt.pad_points(cs.x1, cs.x2, None, 10240))
    cs, _ = data.synthetic_scene(400, 3, 0.15, 1.0, seed=117)
    noisy = _to(dev, *mt.pad_points(cs.x1, cs.x2, None, 512))
    # the stream's second frame, seeded with the first frame's planes
    scfg = MultiHConfig(max_points=512, n_hypotheses=1024)
    frames = [_suite_points(f, 512, dev) for f in streaming.SyntheticStream(
        n_frames=2, n_points=480, n_planes=3, seed=0)]
    prev = mt.make_fit_seeded(scfg)(
        *frames[0], torch.Generator(device=dev).manual_seed(0),
        torch.eye(3, device=dev).expand(scfg.max_labels, 3, 3),
        torch.zeros((scfg.max_labels,), device=dev))
    k7 = ("inlier_counts", "dlt_4pt", "eig9_smallest", "mean_field_fused",
          "icm_fused", "band_list", "window_gather")
    return [
        ("fit N=512", MultiHConfig(max_points=512), "fit", easy, (), K15,
         True),
        ("fit N=1024 BASELINE 2", MultiHConfig(max_points=1024), "fit",
         base2, (), K15, True),
        ("fit fused front", MultiHConfig(max_points=512,
                                         mrf_fused_front=True), "fit", easy,
         (), ("inlier_counts", "dlt_4pt", "eig9_smallest",
              "mean_field_fused_front", "icm_fused", "band_list"), False),
        ("fit stress", stress_cfg(), "fit", stress, (), k7, True),
        ("fit_tau", MultiHConfig(max_points=512), "fit_tau", easy, (tau,),
         K15, False),
        ("fit_seeded", scfg, "fit_seeded", frames[1],
         (prev.homographies, prev.active), K15, False),
        ("fit_adaptive", MultiHConfig(max_points=512), "fit_adaptive",
         noisy, (), K15, False),
    ]


def _fit_diff(a, b) -> list:
    """The leaves in which two fit results (a FitResult, or (FitResult,
    tau)) differ, bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else ["tau"]
    if not hasattr(a, "_fields"):
        return _fit_diff(a[0], b[0]) + _fit_diff(a[1], b[1])
    return [n for n in a._fields
            if not torch.equal(getattr(a, n), getattr(b, n))]


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


def _profile_replays(fn, calls: int = 3):
    """(device busy ms a call, {kernel: launches a call} of the port's
    kernels, device events a call) of `calls` warm calls of fn in one
    torch.profiler session (the counts None where some event name did
    not come back a multiple of `calls` times: a profile can lose
    events)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        busy = busy_us(prof.key_averages()) / calls / 1e3
        if busy > 0:
            break
    check(busy > 0, "the profiler saw no device time")
    names = collections.Counter(
        e.name for e in prof.events() if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False))
    if not all(c % calls == 0 for c in names.values()):
        return busy, None, None
    kernels = {}
    for name, c in names.items():
        for sym, kernel in AOT_SYMBOLS:
            if sym in name:
                kernels[kernel] = kernels.get(kernel, 0) + c // calls
    return busy, kernels, sum(names.values()) // calls


def _aot_cold_starts() -> dict:
    """Host seconds of `python -m multih_tpu_torch.cli synth --json` in a
    fresh process: with --aot on an empty cache root (the kernel build +
    the captures), again on the filled root (load + captures), and
    without --aot on the default build (load, eager fits); the --aot
    runs' results equal the plain run's (a replay is the eager fit)."""
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
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "multih_tpu_torch.cli", "synth",
                 "--json", *extra], cwd=ROOT, env=env, capture_output=True,
                text=True, timeout=600)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0,
                  f"cli synth {extra}: {proc.stderr[-2000:]}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            out[label] = dict(seconds=wall, first_fit_s=res["time_total_s"],
                              warm_fit_s=res["time_warm_s"], result=res)
            print(f"cli synth --json {' '.join(extra)} ({label}): "
                  f"{wall:.2f} s in all, first fit {res['time_total_s']} s,"
                  f" warm fit {res['time_warm_s']} s, planes "
                  f"{res['n_planes_found']}, misclassification "
                  f"{res['misclassification_pct']:.3f}%")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for label in ("aot_empty", "aot_filled"):
        for key in ("n_planes_found", "support", "homographies", "energy",
                    "misclassification_pct"):
            check(out[label]["result"][key] == out["plain"]["result"][key],
                  f"cli synth --aot ({label}) {key} differs from the plain "
                  f"run's")
    return {k: {kk: vv for kk, vv in v.items() if kk != "result"}
            for k, v in out.items()}


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
            lib, path, seconds, rebuilt = _build.open_library(root)
        finally:
            _build.log.removeHandler(handler)
        buf = (ctypes.c_int * 3)()
        rc = lib.multih_inlier_counts_limits(buf)
        warned = [r.getMessage() for r in records
                  if r.levelno >= logging.WARNING]
        print(f"library truncated to 4096 bytes under a temporary cache "
              f"root: rebuilt {rebuilt} in {seconds:.2f} s, warning "
              f"{warned[0][:160] if warned else None!r}, limits rc {rc} "
              f"{list(buf)}")
        check(rebuilt and path == dst and warned and rc == 0
              and os.path.getsize(dst) > 4096,
              "a truncated library was not rebuilt once, with a warning")
        return dict(rebuilt=rebuilt, seconds=seconds)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_aot(dev):
    """Phase 14: utils/aot.cached_fit on each of _aot_cases' cells. On
    each: the eager fit makes no synchronizing call; eager equals eager
    and the first call (warm-up, capture, replay) equals the eager fit
    given equal generator states, every leaf bit for bit and the
    generator's final state; a replay on a second seed equals its eager
    twin and differs from the first; the replay launches every kernel of
    the path (the wrappers' counts during the capture, and the profiler's
    device events of a replay); the capture's seconds and pool bytes; at
    N=512, N=1024 and the stress cell, the warm median of replay and
    eager in turns and the device busy time of each. Then the CLI's cold
    start with and without --aot, and the rebuild of a truncated
    library."""
    import torch

    from multih_tpu_torch.models import pipeline
    from multih_tpu_torch.utils import aot, data, evaluation

    print("== 14. the homography fit's kinds captured as CUDA graphs "
          "(utils/aot.py)")
    t_start = time.perf_counter()
    out, launches = {}, {}
    for label, cfg, kind, pts, extra, expect, timed in _aot_cases(dev):
        t_cell = time.perf_counter()
        maker = {"fit": pipeline.make_fit, "fit_tau": pipeline.make_fit_tau,
                 "fit_seeded": pipeline.make_fit_seeded,
                 "fit_adaptive": pipeline.make_fit_adaptive}[kind](cfg)

        def run(fn, seed):
            g = torch.Generator(device=dev).manual_seed(seed)
            res = fn(*pts, g, *extra)
            torch.cuda.synchronize()
            return res, g.get_state()

        if not out:  # the detector sees a host read
            probe = _sync_sites(lambda: torch.zeros(1, device=dev).item())
            check(probe, "the sync debug mode saw no .item()")
            print(f"sync debug mode on .item(): {probe}")
        sites = _sync_sites(lambda: run(maker, 0))
        check(not sites, f"{label}: synchronizing calls in the eager fit: "
              f"{sites}")
        e0, s0 = run(maker, 0)
        e0b, s0b = run(maker, 0)
        diff = _fit_diff(e0, e0b)
        check(not diff and torch.equal(s0, s0b),
              f"{label}: eager differs from eager in {diff}")
        fn = aot.cached_fit(cfg, kind, device=dev)
        (r0, g0), launches[f"aot {label}"] = count_launches(
            f"aot {label} (warm-up, capture, replay)", expect,
            lambda: run(fn, 0), quiet=True)
        diff = _fit_diff(r0, e0)
        check(not diff and torch.equal(g0, s0),
              f"{label}: the replay differs from the eager fit in {diff} "
              f"(generator state equal: {torch.equal(g0, s0)})")
        r1, g1 = run(fn, 1)
        e1, s1 = run(maker, 1)
        diff = _fit_diff(r1, e1)
        check(not diff and torch.equal(g1, s1),
              f"{label}: the seed-1 replay differs from its eager twin in "
              f"{diff}")
        check(_fit_diff(r0, r1), f"{label}: two seeds, one result")
        per_replay = {k: v for k, v in fn.launches.items() if v}
        for k in expect:
            check(fn.launches[k] > 0, f"{label}: {k} not in the graph")
        res0 = r0[0] if kind == "fit_adaptive" else r0
        row = dict(kind=kind, max_points=cfg.max_points,
                   warmup_s=fn.warmup_s, capture_s=fn.capture_s,
                   pool_bytes=fn.pool_bytes, launches_per_replay=per_replay,
                   planes=int(res0.active.sum()))
        if label.endswith("BASELINE 2"):
            cs, _ = data.synthetic_scene(1000, 2, 0.0, 0.0)
            err = evaluation.misclassification_error(
                res0.labels.cpu().numpy()[:1000], cs.gt_labels,
                cfg.max_labels)
            row["misclassification"] = err
            check(err == 0.0 and row["planes"] == 2,
                  f"{label}: not recovered exactly from the replay "
                  f"({row['planes']} planes, {err}%)")
        if timed:
            reps = 3 if cfg.max_points > 1024 else 10
            t = {"replay": [], "eager": []}
            for _ in range(reps):
                t["replay"] += host_ms(lambda: fn(*pts, torch.Generator(
                    device=dev).manual_seed(5), *extra), reps=1)
                t["eager"] += host_ms(lambda: maker(*pts, torch.Generator(
                    device=dev).manual_seed(5), *extra), reps=1)
            for how in ("replay", "eager"):
                row[f"{how}_ms"] = t[how]
                row[f"{how}_median_ms"] = statistics.median(t[how])
            # the replay's device busy time and, where the profile came
            # back whole, its kernels by name and its device events
            (row["replay_busy_ms"], row["profiler_per_replay"],
             row["device_events_per_replay"]) = _profile_replays(
                lambda: fn(*pts, torch.Generator(device=dev).manual_seed(5),
                           *extra), calls=2)
            check(row["profiler_per_replay"] in (None, per_replay),
                  f"{label}: the profiler saw "
                  f"{row['profiler_per_replay']} in a replay, the capture "
                  f"{per_replay}")
            row["eager_busy_ms"] = device_ms(
                lambda: maker(*pts, torch.Generator(device=dev).manual_seed(
                    5), *extra), reps=2)
        row["seconds"] = time.perf_counter() - t_cell
        out[label] = row
        print(f"aot {label}: replay = eager bit for bit on seeds 0 and 1 "
              f"(and the generator's state); warm-up {fn.warmup_s:.3f} s, "
              f"capture {fn.capture_s:.3f} s, graph pool "
              f"{fn.pool_bytes} bytes; launches a replay {per_replay}; "
              f"planes {row['planes']}; {row['seconds']:.1f} s"
              + (f"; the profiler's kernels a replay "
                 f"{row['profiler_per_replay']}, device events a replay "
                 f"{row['device_events_per_replay']}; warm median replay "
                 f"{row['replay_median_ms']:.2f} ms (device busy "
                 f"{row['replay_busy_ms']:.3f}) against eager "
                 f"{row['eager_median_ms']:.2f} ms (busy "
                 f"{row['eager_busy_ms']:.3f}), {len(row['replay_ms'])} "
                 f"each in turns [{card_line()}]" if timed else ""))
    out["cold_start"] = _aot_cold_starts()
    out["rebuild"] = _aot_rebuild()
    out["seconds"] = time.perf_counter() - t_start
    print(f"phase 14: {out['seconds']:.1f} s")
    return out, launches


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
