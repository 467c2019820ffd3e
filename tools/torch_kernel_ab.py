#!/usr/bin/env python3
"""Time kernels of two trees of the PyTorch + CUDA port on one card, in
turns, beside their library calls, and the fits' device busy time.

    python3 tools/torch_kernel_ab.py --old DIR [--new DIR] [--rounds 1]
        [--parts count dlt eig gather mrf fits]

DIR is a checkout that holds `multih_tpu_torch/` (`--new` defaults to
this repository). Each round runs the trees in the order old, new, new,
old, each in a child process that imports the port from its tree,
builds that tree's kernels into its own `build/` (timed apart from the
rest), and times at chip_smoke.py's phase 3 shapes (`--parts` picks
which, all but dltlanes by default):
  - count: K1 `inlier_counts_padded` at 2051x512 (symmetric, sampson),
    102400x1280 (transfer), 2051x10240 and 16x10240 (symmetric) on the
    stress scene's points and at 2051x512 in the three epipolar kinds on
    fm4_a, in both reciprocal modes where the tree has them, each with
    its CUDA launches a call;
  - dlt: K2 through the pipeline's `_solve_from_gt` on (32, S) sampler
    rows at S=512 and S=51200, with its CUDA launches a call (ok held
    equal to the plain path's; the H's error against it printed, not
    held: a float32 solve, as the parent's kernel is, can miss 5e-4 on
    ~1 quad in 50k);
  - dltlanes (this tree only: `--child . --parts dltlanes`): K2's
    kernel against two variants built from `tools/dlt_lanes.cu` on the
    same rows, at S=512 and S=51200: 4 lanes a solve, and a floor that
    stages and writes the same bytes with no solve;
  - eig: K3 `smallest_eigvec_9x9_batch` on homography normal matrices at
    C=256 (the LO refine) and C=16 (a PEARL refit), and on the 256 F
    normal matrices of a real refit on fm4_a; `torch.linalg.eigh` on
    the same;
  - gather: K7 `window_gather` at the stress shapes (80 windows of
    3B=384 rows; "index" C=8 T=1280, "rank" C=15 T=1600) and, where the
    tree's launch takes a run length (`T_BLOCK`), at runs of (T, 640,
    320, 256, 128) selections a block; `torch.gather` of the same rows
    ("index");
  - mrf: K4 `mean_field_fused`, K5 `icm_fused`, K6
    `mean_field_fused_front` (symmetric; on packed inputs where the tree
    has `labeling.pack_front`, else on the fit's own tensors) and the
    fit's fused call `labeling.pearl_relax_fused` (K6 with the tree's
    packing, if any: the same signature in every tree) at L=17, N=512
    B=256 (6 sweeps, 2 starts x 2 iterations) and N=10240 B=128 (4
    sweeps, 2 x 1), each held to its plain version first, with its CUDA
    launches a call, and the neighbour-list build where the tree has one
    (`band_list`);
  - fits: the default fit at N=512 (easy2_a) and the motion fit at
    N=512 (fm4_a, the motion suite's config): device busy time per fit
    (5 warm fits under torch.profiler) and median latency (10 fits).
Every kernel timing is "call ms" (chip_smoke.cuda_ms: one CUDA-event
pair around one call) and "device ms" (chip_smoke.device_ms: the device
time of the call's kernels alone, from torch.profiler over 50 calls).
Each child prints one line per timing and a JSON line of them; the
card's name and power limit come first and last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This repository's chip_smoke.py (the old tree has its own)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: str, parts) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from multih_tpu_torch.ops.kernels import _build

    cs = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    dev = torch.device("cuda")
    _build.load()
    seconds, log, path = _build.build_report()
    print(f"tree {tree}: {path} built in {seconds:.2f} s")
    for line in log.splitlines():
        if "spill" in line or "registers" in line:
            print("  ptxas:", line.strip().removeprefix("ptxas info    : "))
    out = {}

    def timed(name, fn):
        call, devt = cs.cuda_ms(fn, reps=50), cs.device_ms(fn)
        out[name] = dict(call_ms=call, device_ms=devt)
        print(f"  {name:46s} call {call:8.4f} ms  device {devt:8.4f} ms  "
              f"call - device {call - devt:8.4f} ms")

    for part in parts:
        PARTS[part](cs, dev, timed, out)
    torch.cuda.synchronize()
    return out


def eig_part(cs, dev, timed, out):
    import numpy as np
    import torch

    from multih_tpu_torch.ops.kernels import eig_kernel as ek

    rng = np.random.default_rng(0)
    sets = [(f"C={c}", cs._normal_matrices(rng, c).to(dev).contiguous())
            for c in (256, 16)]
    sets.append(("C=256 F", cs._f_refit_normal_matrices(dev)))
    for label, atas in sets:
        timed(f"eig {label}", lambda: ek.smallest_eigvec_9x9_batch(atas))
        timed(f"eig {label} torch.linalg.eigh",
              lambda: torch.linalg.eigh(atas))


def gather_part(cs, dev, timed, out):
    import numpy as np
    import torch

    from multih_tpu_torch.ops import sampling
    from multih_tpu_torch.ops.kernels import _build
    from multih_tpu_torch.ops.kernels import gather_kernel as gk

    rng = np.random.default_rng(1)
    x1, x2, valid, nbr_idx, _ = cs._windowed_problem(dev, 10000, 10240, 128)
    avail = valid.clone()
    avail[:3000] = 0.0
    win_all = sampling.window_source(x1, x2, avail, nbr_idx, 128)
    nb, rows, _ = win_all.shape
    m_max = int(win_all[:, -1, gk.CUM_CH].max())
    blocks = hasattr(gk, "T_BLOCK")  # the tree's launch takes t_block

    def gather_at(win, sel, mode, t_block):
        """window_gather's launch with t_block selections a block in place
        of the wrapper's T_BLOCK."""
        nb, rows, c = win.shape
        t = sel.shape[1]
        out = torch.empty((nb, c, t), dtype=torch.float32, device=dev)
        _build.check(_build.load().multih_window_gather(
            win.data_ptr(), sel.data_ptr(), nb, rows, c, t, t_block,
            gk.MODES[mode], gk.CUM_CH, out.data_ptr(),
            _build.stream_handle(win)), "window_gather")
        return out
    for mode, t, hi in (("index", 1280, rows + 2), ("rank", 1600, m_max + 8)):
        win = (win_all[:, :, :8] if mode == "index" else win_all).contiguous()
        c = win.shape[2]
        sel = torch.from_numpy(rng.integers(-2, hi, (nb, t)).astype(
            np.int32)).to(dev)
        ref = gk.window_gather_reference(win, sel, mode)
        label = f"gather {mode} C={c} T={t}"
        if not torch.equal(gk.window_gather(win, sel, mode), ref):
            raise AssertionError(f"{label}: not exact")
        timed(label, lambda: gk.window_gather(win, sel, mode))
        for tb in ((t, 640, 320, 256, 128) if blocks else ()):
            if not torch.equal(gather_at(win, sel, mode, tb), ref):
                raise AssertionError(f"{label} t_block {tb}: not exact")
            timed(f"{label} t_block={tb}",
                  lambda: gather_at(win, sel, mode, tb))
        if mode == "index":
            idx = sel.clamp(0, rows - 1).long()[:, :, None].expand(-1, -1, c)
            timed(f"{label} torch.gather", lambda: torch.gather(win, 1, idx))


def mrf_part(cs, dev, timed, out):
    import numpy as np
    import torch

    from multih_tpu_torch.models import labeling
    from multih_tpu_torch.ops.kernels import mrf_kernel as mk

    rng = np.random.default_rng(2)
    has_list = hasattr(mk, "band_list")
    l, sw = 17, 0.1

    for n_points, n, block, sweeps, icm_it in ((500, 512, 256, 6, 2),
                                               (10000, 10240, 128, 4, 1)):
        x1, x2, valid, _, adj = cs._windowed_problem(dev, n_points, n, block)
        band = adj.band
        kw = dict(nbr=adj.nbr) if has_list else {}
        dct = torch.from_numpy(rng.uniform(0, 2.0, (l, n)).astype(
            np.float32)).to(dev) * valid[None, :]
        q0 = torch.softmax(-dct / 2.0, dim=0).contiguous()
        base = (dct + sw * adj.deg.T).contiguous()
        inv_t = torch.from_numpy((1.0 / np.geomspace(2.0, 0.25, sweeps))
                                 .astype(np.float32)).to(dev)
        starts = torch.stack([
            torch.argmin(dct, dim=0),
            torch.from_numpy(rng.integers(0, l, n)).to(dev),
        ]).to(torch.int32).contiguous()
        shape = f"N={n}"
        mf_ref = mk.mean_field_fused_reference(q0, base, band, inv_t, sw)
        icm_ref = mk.icm_fused_reference(starts, base, band, icm_it, sw)

        def k4():
            return mk.mean_field_fused(q0, base, band, inv_t, sw, **kw)

        def k5():
            return mk.icm_fused(starts, base, band, icm_it, sw, **kw)

        hs = np.eye(3)[None] + rng.normal(0, 0.02, (l - 1, 3, 3))
        hs = torch.from_numpy(hs.astype(np.float32)).to(dev)
        active = torch.ones(l - 1, device=dev)
        thr = torch.tensor(9.0, device=dev)
        if hasattr(labeling, "pack_front"):  # K6 on packed inputs
            pts, hm = labeling.pack_front(x1, x2, valid, hs, active, sw, adj)
            k6_args = (q0, pts, hm, band, inv_t, thr, sw, 1.0, "symmetric")
        else:  # K6 on the fit's own tensors
            k6_args = (q0, x1, x2, valid, adj.deg, hs, active, band, inv_t,
                       thr, sw, 1.0, "symmetric")

        def k6():
            return mk.mean_field_fused_front(*k6_args, **kw)

        def relax(use_kernel=True):
            # the fit's fused call, the packing (where the tree has it)
            # included; the same signature in every tree
            return labeling.pearl_relax_fused(
                x1, x2, valid, hs, active, thr, 1.0, sw, sweeps, 2.0, 0.25,
                q0, adj, kind="symmetric", use_kernel=use_kernel)

        q6_ref = mk.mean_field_fused_front_reference(*k6_args)[0]
        relax_ref = relax(use_kernel=False)[0]
        for name, fn, ok in (
                (f"K4 mean-field {shape} sweeps={sweeps}", k4,
                 lambda r: float((r - mf_ref).abs().max()) <= 1e-5),
                (f"K5 ICM {shape} S=2 it={icm_it}", k5,
                 lambda r: torch.equal(r, icm_ref)),
                (f"K6 front {shape} sweeps={sweeps}", k6,
                 lambda r: float((r[0] - q6_ref).abs().max()) <= 1e-4),
                (f"pearl_relax_fused {shape} sweeps={sweeps}", relax,
                 lambda r: float((r[0] - relax_ref).abs().max()) <= 1e-4)):
            if not ok(fn()):
                raise AssertionError(f"{name}: differs from its plain version")
            timed(name, fn)
            out[name]["launches_per_call"] = cs.cuda_launches(fn)[0]
            print(f"  {name:46s} CUDA launches a call "
                  f"{out[name]['launches_per_call']}")
        if has_list:
            timed(f"band_list {shape} B={block}", lambda: mk.band_list(band))


def count_part(cs, dev, timed, out):
    """K1 at chip_smoke.py phase 3's shapes, each held to its plain
    version first (max |dcount| <= 2, mean < 0.5), with its CUDA
    launches a call: in both reciprocal modes where the tree's wrapper
    takes `approx_rcp`, else once ("exact": IEEE division)."""
    import inspect

    import numpy as np
    import torch

    from multih_tpu_torch.ops import fmodel, geometry
    from multih_tpu_torch.ops.kernels import residual_kernel as rk

    rng = np.random.default_rng(3)
    modes = ((True, "approx"), (False, "exact")) if "approx_rcp" in \
        inspect.signature(rk.inlier_counts_padded).parameters else \
        ((None, "exact"),)
    thr = torch.full((), 9.0, device=dev)
    problems = []
    x1, x2, valid = cs._scene_points(10000, 10240, 42, dev)
    for s, n, kind in ((2051, 512, "symmetric"), (2051, 512, "sampson"),
                       (102400, 1280, "transfer"),
                       (2051, 10240, "symmetric"), (16, 10240, "symmetric")):
        idx = torch.from_numpy(rng.integers(0, 10000, (s, 4))).to(dev)
        Hs = geometry.homography_4pt_batch_qr(x1[idx], x2[idx]).contiguous()
        problems.append((Hs, x1[:n], x2[:n], valid[:n], kind))
    f1, f2, fv = cs._motion_points("fm4_a", 512, dev)
    for kind in ("f_sampson", "f_symmetric", "f_transfer"):
        idx = torch.from_numpy(rng.integers(0, int(fv.sum()), (2051, 8))
                               ).to(dev)
        Fs = fmodel.fundamental_8pt_batch_qr(f1[idx], f2[idx]).contiguous()
        problems.append((Fs, f1, f2, fv, kind))
    for Hs, px, py, pv, kind in problems:
        ref = rk.inlier_counts_reference(Hs, px, py, pv, thr, kind)
        for approx, mode in modes:
            kw = {} if approx is None else dict(approx_rcp=approx)

            def fn():
                return rk.inlier_counts_padded(Hs, px, py, pv, thr,
                                               kind=kind, **kw)
            d = (fn() - ref).abs()
            name = f"K1 {Hs.shape[0]}x{px.shape[0]} {kind} {mode}"
            if float(d.max()) > 2.0 or float(d.mean()) >= 0.5:
                raise AssertionError(f"{name}: max {float(d.max())} mean "
                                     f"{float(d.mean())}")
            timed(name, fn)
            out[name]["launches_per_call"] = cs.cuda_launches(fn)[0]
            print(f"  {name:46s} CUDA launches a call "
                  f"{out[name]['launches_per_call']}")


def dlt_part(cs, dev, timed, out):
    """K2 at chip_smoke.py phase 3's S=512 and S=51200: the pipeline's
    `_solve_from_gt` on the sampler's (32, S) rows (collinear, duplicate,
    padded and ~0.01 px quads), against the same call on the plain path
    (ok held equal; the H's max-abs error printed where the plain
    float32 solve is within 1e-4 of float64), with its CUDA launches a
    call."""
    import numpy as np
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.models import pipeline

    rng = np.random.default_rng(4)
    cfg = mt.MultiHConfig()
    plain = mt.MultiHConfig(use_pallas=False)
    for s in (512, 51200):
        gt = cs._sampler_rows(rng, s, dev)
        hs, ok = pipeline._solve_from_gt(gt, cfg)
        ref_h, ref_ok = pipeline._solve_from_gt(gt, plain)
        ref64 = pipeline._solve_from_gt(gt.double(), plain)[0]
        well = (ref_ok > 0) & ((ref_h.double() - ref64).abs().amax((1, 2))
                               < 1e-4)
        err = float((hs - ref_h).abs().amax((1, 2))[well].max())
        if not torch.equal(ok, ref_ok):
            raise AssertionError(f"K2 S={s}: ok differs from the plain "
                                 f"path's")
        print(f"  K2 S={s}: ok equal; H max abs err {err:.3g} vs the plain "
              f"path where its float32 solve is within 1e-4 of float64"
              f"{' (past 5e-4)' if err >= 5e-4 else ''}")
        name = f"K2 _solve_from_gt S={s}"

        def fn():
            return pipeline._solve_from_gt(gt, cfg)
        timed(name, fn)
        out[name]["launches_per_call"] = cs.cuda_launches(fn)[0]
        print(f"  {name:46s} CUDA launches a call "
              f"{out[name]['launches_per_call']}")


def dltlanes_part(cs, dev, timed, out):
    """K2's kernel (`homography_4pt_gt`: one thread a solve, 32 a block)
    against `tools/dlt_lanes.cu`'s 4-lanes-a-solve variant and its floor
    (the same grid, staging and writes, no solve), on the same sampler
    rows (the sampler's transposed view) at S=512 and S=51200. The
    variant is held to what the kernel is held to: ok equal to the plain
    version's, H's within 1e-6 of float64 on every usable quad."""
    import ctypes

    import numpy as np
    import torch

    from multih_tpu_torch.ops.kernels import _build, dlt_kernel

    src = os.path.join(REPO, "tools", "dlt_lanes.cu")
    so = os.path.join(str(_build.library_dir()), "libdlt_lanes.so")
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-shared", src, "-o", so],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    entries = {}
    for name in ("multih_dlt_4pt_gt_lanes", "multih_dlt_4pt_gt_floor"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        entries[name] = fn

    def run(entry, gt):
        s = gt.shape[1]
        h = torch.empty((s, 3, 3), dtype=torch.float32, device=dev)
        ok = torch.empty(s, dtype=torch.float32, device=dev)
        _build.check(entry(gt.data_ptr(), s, *gt.stride(), h.data_ptr(),
                           ok.data_ptr(), _build.stream_handle(gt)), "dlt")
        return h, ok

    rng = np.random.default_rng(5)
    for s in (512, 51200):
        gt = cs._sampler_rows(rng, s, dev)
        ref_h, ref_ok = dlt_kernel.homography_4pt_gt_reference(gt)
        ref64 = dlt_kernel.homography_4pt_gt_reference(gt.double())[0]
        use = ref_ok > 0
        lanes = entries["multih_dlt_4pt_gt_lanes"]
        for label, fn in (
                ("kernel", lambda: dlt_kernel.homography_4pt_gt(gt)),
                ("4 lanes a solve", lambda: run(lanes, gt))):
            h, ok = fn()
            e64 = float((h.double() - ref64).abs().amax((1, 2))[use].max())
            if not torch.equal(ok, ref_ok) or not e64 < 1e-6:
                raise AssertionError(f"K2 {label} S={s}: ok equal "
                                     f"{torch.equal(ok, ref_ok)}, max abs "
                                     f"err vs float64 {e64}")
            print(f"  K2 {label} S={s}: ok equal, max abs err vs float64 "
                  f"{e64:.3g}")
            timed(f"K2 {label} S={s}", fn)
        floor = entries["multih_dlt_4pt_gt_floor"]
        timed(f"K2 floor (stage and write, no solve) S={s}",
              lambda: run(floor, gt))


def fits_part(cs, dev, timed, out):
    """The default fit at N=512 (easy2_a, the golden tau) and the motion
    fit on fm4_a (chip_smoke phase 6's warm fit): device busy time per fit
    (every kernel's and copy's device time, 5 warm fits) and the median
    host-clock latency of 10."""
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import data

    scene = data.suite_scene("easy2_a")
    args = [torch.from_numpy(a).to(dev)
            for a in mt.pad_points(scene.x1, scene.x2, None, 512)]
    fits = (("default fit N=512", mt.make_fit_tau(
                mt.MultiHConfig(max_points=512)), args),
            ("motion fit fm4_a N=512", mt.make_fit_tau(cs.motion_cfg(512)),
             cs._motion_points("fm4_a", 512, dev)))
    for label, fit, fargs in fits:
        gen = torch.Generator(device=dev).manual_seed(0)
        busy = cs.device_ms(lambda: fit(*fargs, gen, 3.0), reps=5)
        lat = statistics.median(cs.host_ms(lambda: fit(*fargs, gen, 3.0), 10))
        out[label] = dict(device_ms=busy, latency_ms=lat)
        print(f"  {label}: device busy {busy:.3f} ms a fit, latency median "
              f"{lat:.2f} ms")


PARTS = {"count": count_part, "dlt": dlt_part, "dltlanes": dltlanes_part,
         "eig": eig_part,
         "gather": gather_part, "mrf": mrf_part, "fits": fits_part}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", help="the tree timed first and last")
    ap.add_argument("--new", default=REPO)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--parts", nargs="+", choices=sorted(PARTS),
                    default=[p for p in PARTS if p != "dltlanes"])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps({"tree": args.child,
                          "times": child(args.child, args.parts)}))
        return 0
    if not args.old:
        ap.error("--old is required")
    cs = _chip_smoke()
    print(cs.card_line())
    rc = 0
    for _ in range(args.rounds):
        for tree in (args.old, args.new, args.new, args.old):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--child", tree, "--parts", *args.parts],
                                  text=True,
                                  capture_output=True, timeout=900)
            print(proc.stdout, end="")
            if proc.returncode:
                print(proc.stderr[-4000:], file=sys.stderr)
                rc = proc.returncode
    print(cs.card_line())
    return rc


if __name__ == "__main__":
    sys.exit(main())
