#!/usr/bin/env python3
"""The homography golden contract of tests/test_torch_kernels.py on the
card, per scene and key, with the fit's 9x9 eigensolves taken by one
solver or another.

    python3 tools/torch_golden_eig.py [--tree DIR] [--solvers kernel,...]
                                      [--scenes name,...] [--keys N]

Solvers: "kernel" (the tree's K3, the card fit's own path), "eigh"
(torch.linalg.eigh, the CPU fit's), "cyclic" and "round_robin" (the
plain Jacobi versions in ops/kernels/eig_kernel.py, where the tree has
them). Every other kernel runs as in the card fit. Each scene is fitted
as test_golden_scene fits it (the golden tau, CPU-generator keys 0-2, or
0-5 below 200 points; --keys N takes keys 0..N-1 instead, to see the
spread the test's three keys sample); one line per scene and solver
gives the keys' misclassification, the mean's distance from the golden
and the test's bound, and the agreement with the golden labels on key
0.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--solvers", default="kernel,eigh,cyclic,round_robin")
    ap.add_argument("--scenes", default="")
    ap.add_argument("--keys", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.ops import geometry
    from multih_tpu_torch.ops.kernels import eig_kernel as ek
    from multih_tpu_torch.ops.sampling import TorchDraws
    from multih_tpu_torch.utils import data, evaluation

    if not torch.cuda.is_available():
        print("torch_golden_eig: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kernel = geometry.smallest_eigvecs
    solvers = {
        "kernel": kernel,
        "eigh": lambda a, *_: geometry.smallest_eigvec_9x9(a, 6, "eigh"),
        "cyclic": lambda a, *_: ek.smallest_eigvec_9x9_batch_reference(a),
    }
    if hasattr(ek, "smallest_eigvec_9x9_round_robin_reference"):
        solvers["round_robin"] = (
            lambda a, *_: ek.smallest_eigvec_9x9_round_robin_reference(a))
    names = (args.scenes.split(",") if args.scenes
             else [row[0] for row in data.SUITE])
    goldens = os.path.join(REPO, "tests", "goldens")
    print(f"tree {args.tree}")
    for solver in args.solvers.split(","):
        if solver not in solvers:
            print(f"{solver}: not in this tree")
            continue
        geometry.smallest_eigvecs = solvers[solver]
        deltas, fails = [], []
        for name in names:
            cs = data.suite_scene(name)
            npad = 1 << max(9, (cs.n_points - 1).bit_length())
            cfg = mt.MultiHConfig(max_points=npad)
            g = np.load(os.path.join(goldens, f"{name}.npz"))
            x = [torch.from_numpy(a).to(dev)
                 for a in mt.pad_points(cs.x1, cs.x2, None, npad)]
            fit = mt.make_fit_tau(cfg)
            errs, agree = [], None
            for k in range(args.keys or (3 if cs.n_points >= 200 else 6)):
                res = fit(*x, TorchDraws(torch.Generator().manual_seed(k)),
                          float(g["inlier_threshold"]))
                lab = res.labels.cpu().numpy()[: cs.n_points]
                errs.append(evaluation.misclassification_error(
                    lab, cs.gt_labels, cfg.max_labels))
                if agree is None:
                    agree = 100.0 - evaluation.misclassification_error(
                        lab, g["labels"], cfg.max_labels,
                        gt_outlier=int(g["outlier_label"]))
            delta = float(np.mean(errs)) - float(g["misclassification"])
            bound = 0.5 + min(2.0 * 100.0 / cs.n_points, 1.0)
            deltas.append(delta)
            ok = abs(delta) <= bound and agree >= 97.0
            if not ok:
                fails.append(name)
            print(f"{solver:11s} {name:14s} keys "
                  f"{' '.join(f'{e:.3f}' for e in errs)}  delta "
                  f"{delta:+.3f} pp (bound {bound:.3f})  agreement "
                  f"{agree:.2f}%{'' if ok else '  FAILS'}", flush=True)
        print(f"{solver}: suite mean delta {np.mean(deltas):+.4f} pp, "
              f"failing {fails}", flush=True)
    geometry.smallest_eigvecs = kernel
    return 0


if __name__ == "__main__":
    sys.exit(main())
