"""Command-line interface of the PyTorch port: correspondences in, per-point
plane (or motion) labels and models out, with the misclassification error
printed when ground truth is available.

Counterpart of ``multih_tpu/cli.py`` with the same subcommands and
arguments, run on a CUDA card by default (``--device``, in place of the
JAX CLI's ``--platform``); without a card it raises unless given
``--device cpu``. ``fit-images`` needs OpenCV on the host (exit 2
without it). ``--aot`` (or MULTIH_AOT=1) takes the homography fits of
``fit``, ``synth`` and ``fit-images`` through ``utils/aot.cached_fit``:
each fit kind captured once as a CUDA graph and replayed, the kernel
library from the MULTIH_AOT_CACHE root (by default the build directory);
on ``--device cpu`` it is the plain fit. As in the JAX CLI, ``stream``,
``bench-adelaide`` and ``fit-images --use-affines`` fit eagerly with it.
Not ported yet, and refused with a nonzero exit:
``--aot`` with ``--model fundamental`` or ``mixed``, and ``--save-viz``.

Example:
    multih-torch fit data/johnsona.mat --threshold 3.0 --lambda 0.3
    multih-torch synth --planes 3 --points 600 --noise 0.5 --json
    multih-torch fit-images left.png right.png --use-affines
    multih-torch bench-adelaide path/to/adelaide_dir
    torchrun --nproc-per-node 2 -m multih_tpu_torch.cli bench-adelaide dir
    multih-torch stream synth --frames 30
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _build_config(args):
    from multih_tpu_torch.config import MultiHConfig

    n = args.n_points_hint
    max_points = 1 << max(6, (n - 1).bit_length())  # next pow2 bucket >= n
    return MultiHConfig(
        inlier_threshold=args.threshold,
        spatial_weight=args.spatial_weight,
        label_cost=args.label_cost,
        max_points=max_points,
        n_hypotheses=args.hypotheses,
        max_labels=args.max_labels,
        pearl_iterations=args.iterations,
        min_inliers=args.min_inliers,
        residual=args.residual,
        model=getattr(args, "model", "homography"),
    )


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--threshold", type=float, default=3.0,
                   help="inlier threshold in px (tau)")
    p.add_argument("--spatial-weight", "--lambda", dest="spatial_weight",
                   type=float, default=0.1, help="Potts smoothness weight")
    p.add_argument("--label-cost", "--beta", dest="label_cost", type=float,
                   default=20.0, help="per-plane label cost")
    p.add_argument("--hypotheses", type=int, default=2048)
    p.add_argument("--max-labels", type=int, default=16)
    p.add_argument("--iterations", type=int, default=8,
                   help="PEARL alternation count")
    p.add_argument("--min-inliers", type=int, default=10)
    p.add_argument("--residual", default="symmetric",
                   choices=["symmetric", "transfer", "sampson"])
    p.add_argument("--model", default="homography",
                   choices=["homography", "fundamental", "mixed"],
                   help="geometric model class: 'homography' = multiple "
                        "scene planes; 'fundamental' = multi-motion "
                        "segmentation; 'mixed' = planes AND motions in one "
                        "label space")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--restarts", type=int, default=1,
                   help="fit this many times with different seeds and keep "
                        "the lowest-energy result")
    p.add_argument("--adaptive-tau", action="store_true",
                   help="self-calibrate the inlier threshold from a probe "
                        "pass (overrides --threshold)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the fit (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch paths)")
    p.add_argument("--aot", action="store_true",
                   default=os.environ.get("MULTIH_AOT", "") == "1",
                   help="capture each homography fit kind once as a CUDA "
                        "graph and replay it (utils/aot.py; the kernel "
                        "library under MULTIH_AOT_CACHE); also via "
                        "MULTIH_AOT=1. Not ported for --model fundamental "
                        "or mixed (exits nonzero)")
    p.add_argument("--json", action="store_true",
                   help="emit machine-readable JSON on stdout")
    p.add_argument("--save-labels", default=None,
                   help="write per-point labels to this file")
    p.add_argument("--save-viz", default=None,
                   help="not ported yet (exits nonzero)")


def _not_ported(what: str):
    print(f"{what} is not ported to multih_tpu_torch yet; use the JAX CLI "
          f"(multih)", file=sys.stderr)
    sys.exit(2)


def _reject_mixed(args, what: str):
    """Subcommands whose path is single-class fail loudly on --model mixed
    instead of fitting homographies under a mixed banner."""
    if getattr(args, "model", "homography") == "mixed":
        print(f"--model mixed is not supported by {what}; run 'fit'/"
              f"'synth' for the mixed multi-class path", file=sys.stderr)
        sys.exit(2)


def _device(args) -> torch.device:
    """The fit's device; the card unless --device says otherwise, and
    never a quiet fallback to the CPU."""
    if args.aot and getattr(args, "model", "homography") != "homography":
        _not_ported(f"--aot with --model {args.model}")
    if args.save_viz:
        _not_ported("--save-viz")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    return dev


def _timed(dev: torch.device, fn):
    """(fn(), host seconds until its work on `dev` has finished)."""
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def _padded(cs, max_points):
    from multih_tpu_torch.models.pipeline import pad_points

    if cs.gt_labels is not None:
        return pad_points(cs.x1, cs.x2, cs.gt_labels, max_points)
    return pad_points(cs.x1, cs.x2, None, max_points) + (None,)


def _fit_one_mixed(cs, args):
    """`--model mixed`: plane stage + motion stage + joint polish
    (models/mixed.py). Restarts keep the lowest joint-energy result;
    --adaptive-tau calibrates one threshold per class and freezes both
    for the restarts."""
    from multih_tpu_torch.models import mixed
    from multih_tpu_torch.utils import evaluation

    dev = _device(args)
    args.n_points_hint = cs.n_points
    args.model = "homography"
    cfg_h = _build_config(args)
    args.model = "fundamental"
    args_f_res = args.residual
    args.residual = "sampson"  # epipolar stage: first-order geometric
    cfg_f = _build_config(args)
    args.residual = args_f_res
    args.model = "mixed"

    x1, x2, valid, gt = _padded(cs, cfg_h.max_points)
    adaptive = args.adaptive_tau
    if adaptive:
        f_ad = mixed.make_fit_mixed_adaptive(cfg_h, cfg_f, device=dev)

        def f(k):
            r_, th_, tf_ = f_ad(x1, x2, valid, k)
            return r_, (th_, tf_)
    else:
        f_fix = mixed.make_fit_mixed(cfg_h, cfg_f, device=dev)

        def f(k):
            return f_fix(x1, x2, valid, k), None

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    (res, taus), t_total = _timed(dev, lambda: f(gen(args.seed)))
    (res, taus), t_warm = _timed(dev, lambda: f(gen(args.seed + 1)))
    # restarts under the frozen per-class taus: energies stay comparable
    if args.restarts > 1 and adaptive:
        f_tau = mixed.make_fit_mixed_tau(cfg_h, cfg_f, device=dev)

        def f_restart(k):
            return f_tau(x1, x2, valid, k, *taus)
    else:
        def f_restart(k):
            return f(k)[0]
    for r in range(1, max(args.restarts, 1)):
        cand = f_restart(gen(args.seed + 7919 * r))
        if float(cand.energy) < float(res.energy):
            res = cand

    k_union = cfg_h.max_labels + cfg_f.max_labels
    labels = res.labels.cpu().numpy()[: cs.n_points]
    active = res.active.cpu().numpy()
    is_f = res.is_f.cpu().numpy()
    support = res.support.cpu().numpy()
    out = {
        "name": cs.name,
        "n_points": cs.n_points,
        "n_planes_found": int(active[is_f == 0].sum()),
        "n_motions_found": int(active[is_f == 1].sum()),
        "support_planes": support[(active > 0) & (is_f == 0)].tolist(),
        "support_motions": support[(active > 0) & (is_f == 1)].tolist(),
        "energy": float(res.energy),
        "time_total_s": round(t_total, 4),
        "time_warm_s": round(t_warm, 4),
    }
    if taus is not None:
        out["tau_h"] = round(float(taus[0]), 3)
        out["tau_f"] = round(float(taus[1]), 3)
    if gt is not None:
        out["misclassification_pct"] = evaluation.misclassification_error(
            labels, gt[: cs.n_points], k_union
        )
    models = res.models.cpu().numpy()[active > 0]
    kinds = ["F" if v else "H" for v in is_f[active > 0]]
    if args.json:
        out["models"] = models.tolist()
        out["model_kinds"] = kinds
        print(json.dumps(out))
    else:
        print(f"pair: {out['name']}  points: {out['n_points']}")
        print(f"planes found: {out['n_planes_found']}  "
              f"support: {out['support_planes']}")
        print(f"motions found: {out['n_motions_found']}  "
              f"support: {out['support_motions']}")
        if "tau_h" in out:
            print(f"calibrated tau_h: {out['tau_h']:.2f} px  "
                  f"tau_f: {out['tau_f']:.2f} px")
        if "misclassification_pct" in out:
            print(f"misclassification: {out['misclassification_pct']:.2f}%")
        print(f"energy: {out['energy']:.2f}  warm latency: "
              f"{out['time_warm_s']*1e3:.2f} ms")
        for i, (m, kind) in enumerate(zip(models, kinds)):
            print(f"{kind}[{i}] =")
            for row in m:
                print("   ", " ".join(f"{v:+.6e}" for v in row))
    if args.save_labels:
        np.savetxt(args.save_labels, labels, fmt="%d")
    return out


def _fit_one(cs, args):
    import multih_tpu_torch as mt
    from multih_tpu_torch.utils import evaluation

    if getattr(args, "model", "homography") == "mixed":
        return _fit_one_mixed(cs, args)
    dev = _device(args)
    args.n_points_hint = cs.n_points
    cfg = _build_config(args)
    x1, x2, valid, gt = _padded(cs, cfg.max_points)

    if args.aot:
        from multih_tpu_torch.utils import aot

        def maker(kind):
            return aot.cached_fit(cfg, kind, device=dev)
    else:
        def maker(kind):
            return {"fit": mt.make_fit, "fit_tau": mt.make_fit_tau,
                    "fit_adaptive": mt.make_fit_adaptive}[kind](
                        cfg, device=dev)

    adaptive = args.adaptive_tau
    if adaptive:
        f_ad = maker("fit_adaptive")

        def f(k):
            return f_ad(x1, x2, valid, k)
    else:
        f_fix = maker("fit")

        def f(k):
            return f_fix(x1, x2, valid, k), None

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    (res, tau), t_total = _timed(dev, lambda: f(gen(args.seed)))
    # steady-state latency: the kernels built and loaded, a fresh seed
    (res, tau), t_warm = _timed(dev, lambda: f(gen(args.seed + 1)))
    # optional restarts, the lowest energy kept; under adaptive tau the
    # timed run's threshold is frozen for every restart, so the energies
    # share one data-cost scale
    if args.restarts > 1 and adaptive:
        f_tau = maker("fit_tau")

        def f_restart(k):
            return f_tau(x1, x2, valid, k, tau)
    else:
        def f_restart(k):
            return f(k)[0]
    for r in range(1, max(args.restarts, 1)):
        cand = f_restart(gen(args.seed + 7919 * r))
        if float(cand.energy) < float(res.energy):
            res = cand

    labels = res.labels.cpu().numpy()[: cs.n_points]
    active = res.active.cpu().numpy()
    out = {
        "name": cs.name,
        "n_points": cs.n_points,
        "n_planes_found": int(active.sum()),
        "support": res.support.cpu().numpy()[active > 0].tolist(),
        "energy": float(res.energy),
        "time_total_s": round(t_total, 4),
        "time_warm_s": round(t_warm, 4),
    }
    if tau is not None:
        out["tau"] = round(float(tau), 3)
    n_far_dropped = int(res.n_far_dropped)
    if n_far_dropped:
        # banded-operator capacity overflow: the Potts energy lost edges
        out["n_far_dropped"] = n_far_dropped
    if gt is not None:
        out["misclassification_pct"] = evaluation.misclassification_error(
            labels, gt[: cs.n_points], cfg.max_labels
        )
    homos = res.homographies.cpu().numpy()[active > 0]

    if args.json:
        out["homographies"] = homos.tolist()
        print(json.dumps(out))
    else:
        print(f"pair: {out['name']}  points: {out['n_points']}")
        print(f"planes found: {out['n_planes_found']}  "
              f"support: {out['support']}")
        if "misclassification_pct" in out:
            print(f"misclassification: {out['misclassification_pct']:.2f}%")
        print(f"energy: {out['energy']:.2f}  warm latency: "
              f"{out['time_warm_s']*1e3:.2f} ms")
        for i, h in enumerate(homos):
            print(f"H[{i}] =")
            for row in h:
                print("   ", " ".join(f"{v:+.6e}" for v in row))
    if args.save_labels:
        np.savetxt(args.save_labels, labels, fmt="%d")
    return out


def cmd_fit(args):
    from multih_tpu_torch.utils import data

    if args.input.endswith(".mat"):
        cs = data.load_adelaide_mat(args.input)
    else:
        cs = data.load_correspondences_txt(args.input)
    _fit_one(cs, args)


def cmd_fit_images(args):
    """Raw image pair -> SIFT matching -> fit (cli.py:394), optionally
    feeding the matches' affine frames into the paper's one-point
    hypothesis path (`fit(affines=...)`). Exits 2 without OpenCV."""
    dev = _device(args)
    try:
        import cv2
    except ImportError:
        print("fit-images needs OpenCV (cv2), which does not import here",
              file=sys.stderr)
        sys.exit(2)
    from multih_tpu_torch.utils import features

    img1 = cv2.imread(args.image1, cv2.IMREAD_GRAYSCALE)
    img2 = cv2.imread(args.image2, cv2.IMREAD_GRAYSCALE)
    if img1 is None or img2 is None:
        print("could not read input images", file=sys.stderr)
        sys.exit(1)
    cs, affines = features.detect_and_match(
        img1, img2, max_features=args.max_features, ratio=args.ratio)
    if cs.n_points < 8:
        print(f"only {cs.n_points} matches — not enough", file=sys.stderr)
        sys.exit(1)
    print(f"matched {cs.n_points} correspondences", file=sys.stderr)
    if not args.use_affines:
        _fit_one(cs, args)
        return

    import multih_tpu_torch as mt

    _reject_mixed(args, "fit-images --use-affines (homography one-point "
                        "hypothesis path)")
    args.n_points_hint = cs.n_points
    cfg = _build_config(args)
    x1, x2, valid = mt.pad_points(cs.x1, cs.x2, None, cfg.max_points)
    aff = np.tile(np.eye(2, dtype=np.float32), (cfg.max_points, 1, 1))
    aff[: cs.n_points] = affines
    res = mt.fit(x1, x2, valid,
                 torch.Generator(device=dev).manual_seed(args.seed), cfg,
                 affines=aff, device=dev)
    active = res.active.cpu().numpy()
    labels = res.labels.cpu().numpy()[: cs.n_points]
    out = {
        "name": f"{args.image1}|{args.image2}",
        "n_points": cs.n_points,
        "n_planes_found": int(active.sum()),
        "support": res.support.cpu().numpy()[active > 0].tolist(),
    }
    print(json.dumps(out) if args.json else
          "\n".join(f"{k}: {v}" for k, v in out.items()))
    if args.save_labels:
        np.savetxt(args.save_labels, labels, fmt="%d")


def cmd_synth(args):
    from multih_tpu_torch.utils import data

    if args.model == "mixed":
        cs, _, _ = data.synthetic_mixed_scene(
            n_points=args.points, n_planes=args.planes,
            n_motions=args.motions, outlier_rate=args.outliers,
            noise_px=args.noise, seed=args.seed,
        )
    elif args.model == "fundamental":
        cs, _ = data.synthetic_motion_scene(
            n_points=args.points, n_motions=args.planes,
            outlier_rate=args.outliers, noise_px=args.noise,
            seed=args.seed,
        )
    else:
        cs, _ = data.synthetic_scene(
            n_points=args.points, n_planes=args.planes,
            outlier_rate=args.outliers, noise_px=args.noise,
            seed=args.seed,
        )
    _fit_one(cs, args)


def _world_mesh(dev: torch.device):
    """make_mesh() over every rank when the process is one of several:
    started under torchrun (WORLD_SIZE set; the process group is joined
    here, NCCL on the card, gloo on the CPU) or inside a joined group;
    else None. On the card each rank takes cuda:<LOCAL_RANK % cards>."""
    import os

    import torch.distributed as dist

    from multih_tpu_torch.parallel import sharding

    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return None
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    mesh = sharding.make_mesh(device="cpu" if dev.type == "cpu" else None)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    return mesh


def cmd_bench_adelaide(args):
    """The AdelaideRMF homography pairs as one batch
    (parallel/sharding.run_benchmark_batch): every pair padded to one
    bucket and uploaded once, one global tau or --adaptive-tau for
    per-pair self-calibration; a cold and a warm pass. Under torchrun the
    pairs split over the ranks (make_mesh(): every rank on the 'pair'
    axis), every rank fits its share, and only rank 0 prints."""
    from multih_tpu_torch.parallel import sharding
    from multih_tpu_torch.utils import data, evaluation

    paths = data.adelaide_pairs(args.root)
    if not paths:
        print(f"no AdelaideRMF .mat files found under {args.root}",
              file=sys.stderr)
        sys.exit(1)
    _reject_mixed(args, "bench-adelaide (single-class batched dispatch)")
    dev = _device(args)
    mesh = _world_mesh(dev)
    if mesh is not None:
        dev = mesh.device
    css = [data.load_adelaide_mat(p) for p in paths]
    args.n_points_hint = max(cs.n_points for cs in css)
    cfg = _build_config(args)
    prepared = sharding.prepare_benchmark_batch(css, cfg, device=dev,
                                                mesh=mesh)

    def run(seed):
        return sharding.run_benchmark_batch(
            css, cfg, seed=seed, adaptive=args.adaptive_tau,
            prepared=prepared, mesh=mesh)

    res, t_total = _timed(dev, lambda: run(args.seed))  # kernels built
    res, t_warm = _timed(dev, lambda: run(args.seed + 1))
    if mesh is not None and mesh.rank != 0:
        return

    errs = []
    for i, cs in enumerate(css):
        row = {
            "name": cs.name,
            "n_points": cs.n_points,
            "n_planes_found": int(res.active[i].sum()),
        }
        if cs.gt_labels is not None:
            labels = res.labels[i][: cs.n_points]
            err = evaluation.misclassification_error(
                labels, cs.gt_labels, cfg.max_labels
            )
            row["misclassification_pct"] = round(err, 3)
            errs.append(err)
        print(json.dumps(row))
    summary = {
        "pairs": len(css),
        "mean_misclassification_pct": (
            round(float(np.nanmean(errs)), 3) if errs else None
        ),
        "batch_wall_s_cold": round(t_total, 3),
        "batch_wall_s_warm": round(t_warm, 3),
        "devices": 1 if mesh is None else mesh.ranks.size,
    }
    print(json.dumps({"summary": summary}))


def cmd_stream(args):
    from multih_tpu_torch.utils import streaming

    _reject_mixed(args, "stream (single-class frame pipeline)")
    dev = _device(args)
    args.n_points_hint = 480
    cfg = _build_config(args)
    if args.source == "synth":
        src = streaming.SyntheticStream(n_frames=args.frames, n_points=480,
                                        n_planes=3, seed=args.seed)
    else:
        src = streaming.DirectoryStream(args.source)
    stats = streaming.run_stream(
        src, cfg, budget_ms=args.budget_ms,
        pipeline_depth=args.pipeline_depth,
        warm_start=not args.no_warm_start,
        upload="preload" if args.preload else "stream", device=dev,
    )
    out = {
        "frames": stats.frames,
        "fps": round(stats.fps, 1),
        "latency_p50_ms": round(stats.p50_ms, 3),
        "latency_p95_ms": round(stats.p95_ms, 3),
        "mean_planes": round(stats.mean_planes, 2),
        "budget_ms": stats.budget_ms,
        "meets_budget": stats.meets_budget(),
    }
    print(json.dumps(out) if args.json else
          "\n".join(f"{k}: {v}" for k, v in out.items()))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="multih-torch",
        description="Multi-homography recovery on a CUDA card (the PyTorch "
                    "port of multih_tpu)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_fit = sub.add_parser("fit", help="fit one correspondence file")
    p_fit.add_argument("input", help=".mat (AdelaideRMF) or text x y x' y'")
    _add_common(p_fit)
    p_fit.set_defaults(fn=cmd_fit)

    p_im = sub.add_parser(
        "fit-images",
        help="detect+match SIFT features on an image pair, then fit",
    )
    p_im.add_argument("image1")
    p_im.add_argument("image2")
    p_im.add_argument("--max-features", type=int, default=4000)
    p_im.add_argument("--ratio", type=float, default=0.8)
    p_im.add_argument("--use-affines", action="store_true",
                      help="add affine+F one-point hypotheses (paper path)")
    _add_common(p_im)
    p_im.set_defaults(fn=cmd_fit_images)

    p_sy = sub.add_parser("synth", help="fit a synthetic scene")
    p_sy.add_argument("--points", type=int, default=500)
    p_sy.add_argument("--planes", type=int, default=2,
                      help="planes (or motions with --model fundamental)")
    p_sy.add_argument("--motions", type=int, default=1,
                      help="independently moving non-planar rigid bodies "
                           "(--model mixed only)")
    p_sy.add_argument("--outliers", type=float, default=0.1)
    p_sy.add_argument("--noise", type=float, default=0.5)
    _add_common(p_sy)
    p_sy.set_defaults(fn=cmd_synth)

    p_b = sub.add_parser("bench-adelaide",
                         help="run the 19-pair AdelaideRMF benchmark")
    p_b.add_argument("root", help="directory containing the .mat files")
    _add_common(p_b)
    p_b.set_defaults(fn=cmd_bench_adelaide)

    p_st = sub.add_parser(
        "stream",
        help="per-frame fitting on a frame stream (dir of files, or "
             "'synth') under a real-time budget",
    )
    p_st.add_argument("source", help="directory of .txt/.mat frames, or "
                                     "'synth' for the synthetic stream")
    p_st.add_argument("--frames", type=int, default=60)
    p_st.add_argument("--budget-ms", type=float, default=33.3)
    p_st.add_argument("--pipeline-depth", type=int, default=3)
    p_st.add_argument("--no-warm-start", action="store_true",
                      help="disable seeding each frame's candidate pool "
                           "with the previous frame's planes")
    p_st.add_argument("--preload", action="store_true",
                      help="upload all frames before timing (isolates "
                           "device compute from transfer; default is "
                           "per-frame upload, the deployment shape)")
    _add_common(p_st)
    p_st.set_defaults(fn=cmd_stream)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
