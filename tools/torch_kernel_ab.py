#!/usr/bin/env python3
"""Time kernels of two trees of the PyTorch + CUDA port on one card, in
turns, beside their library calls, and the fits' device busy time.

    python3 tools/torch_kernel_ab.py --old DIR [--new DIR] [--rounds 1]
        [--parts eig gather mrf fits]

DIR is a checkout that holds `multih_tpu_torch/` (`--new` defaults to
this repository). Each round runs the trees in the order old, new, new,
old, each in a child process that imports the port from its tree,
builds that tree's kernels into its own `build/` (timed apart from the
rest), and times at chip_smoke.py's phase 3 shapes (`--parts` picks
which, all by default):
  - eig: K3 `smallest_eigvec_9x9_batch` on homography normal matrices at
    C=256 (the LO refine) and C=16 (a PEARL refit), and on the 256 F
    normal matrices of a real refit on fm4_a; `torch.linalg.eigh` on
    the same;
  - gather: K7 `window_gather` at the stress shapes (80 windows of
    3B=384 rows; "index" C=8 T=1280, "rank" C=15 T=1600) and, where the
    tree's launch takes a run length (`T_BLOCK`), at runs of (T, 640,
    320, 256, 128) selections a block; `torch.gather` of the same rows
    ("index");
  - mrf: K4 `mean_field_fused`, K5 `icm_fused` and K6
    `mean_field_fused_front` (symmetric) at L=17, N=512 B=256 (6 sweeps,
    2 starts x 2 iterations) and N=10240 B=128 (4 sweeps, 2 x 1), each
    held to its plain version first, with its CUDA launches a call, and
    the neighbour-list build where the tree has one (`band_list`);
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
        pts, hm = labeling.pack_front(x1, x2, valid, hs,
                                      torch.ones(l - 1, device=dev), sw, adj)
        thr = torch.tensor(9.0, device=dev)

        def k6():
            return mk.mean_field_fused_front(q0, pts, hm, band, inv_t, thr,
                                             sw, 1.0, "symmetric", **kw)

        q6_ref = mk.mean_field_fused_front_reference(
            q0, pts, hm, band, inv_t, thr, sw, 1.0, "symmetric")[0]
        for name, fn, ok in (
                (f"K4 mean-field {shape} sweeps={sweeps}", k4,
                 lambda r: float((r - mf_ref).abs().max()) <= 1e-5),
                (f"K5 ICM {shape} S=2 it={icm_it}", k5,
                 lambda r: torch.equal(r, icm_ref)),
                (f"K6 front {shape} sweeps={sweeps}", k6,
                 lambda r: float((r[0] - q6_ref).abs().max()) <= 1e-4)):
            if not ok(fn()):
                raise AssertionError(f"{name}: differs from its plain version")
            timed(name, fn)
            out[name]["launches_per_call"] = cs.cuda_launches(fn)[0]
            print(f"  {name:46s} CUDA launches a call "
                  f"{out[name]['launches_per_call']}")
        if has_list:
            timed(f"band_list {shape} B={block}", lambda: mk.band_list(band))


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


PARTS = {"eig": eig_part, "gather": gather_part, "mrf": mrf_part,
         "fits": fits_part}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", help="the tree timed first and last")
    ap.add_argument("--new", default=REPO)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--parts", nargs="+", choices=sorted(PARTS),
                    default=list(PARTS))
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
