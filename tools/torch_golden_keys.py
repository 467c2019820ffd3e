#!/usr/bin/env python3
"""Many-key misclassification of golden homography scenes, the JAX
package against the port, on the CPU.

    python3 tools/torch_golden_keys.py [--keys 32]
                                       [--scenes easy2_a,med3_a,outlier50_b]
                                       [--packages jax,torch] [--json FILE]
    python3 tools/torch_golden_keys.py --scenes pt_fmodel

Each scene is fitted as the golden tests fit it: the default config at
max_points the next power of two >= 512 above the scene's points, the
golden tau, and keys 0..K-1 -- ``jax.random.key(i)`` through
``multih_tpu.make_fit_tau`` for the reference, a CPU
``torch.Generator().manual_seed(i)`` through the port's
``make_fit_tau(device="cpu")``. One line per scene and package gives the
mean misclassification over the keys, its standard error, the golden
value, and the first three keys (the three that
tests/test_torch_kernels.py::test_golden_scene averages); then, per
scene, the gap between the two means in units of their joint standard
error. A gap above 2 says the two packages' draws give different
distributions of the fit's result; below, the three-key means of the
golden test differ by draw noise.

Besides the golden scenes, ``--scenes`` takes the names of SYNTHETIC:
a scene made from a seed with its own config, fitted by ``make_fit`` at
the config's threshold with the same keys. ``pt_fmodel`` is the "fmodel"
case of tests/test_torch_mesh.py's 'pt' fits (a 3-motion scene of 470
points, the fundamental model at N=512); its "golden" is null.

This tool imports both packages; nothing of the port imports it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens")


# name -> (scene maker, config): scenes fitted at their config's own
# threshold (tau None)
SYNTHETIC = {
    "pt_fmodel": (
        lambda data: data.synthetic_motion_scene(470, 3, 0.1, 0.5, seed=7)[0],
        dict(max_points=512, agree_block=64, n_hypotheses=512,
             n_candidates=64, max_labels=8, model="fundamental",
             residual="sampson", inlier_threshold=3.0)),
}


def _npad(n_points: int) -> int:
    return 1 << max(9, (n_points - 1).bit_length())


def _cfg_kw(cs, cfg_kw):
    return cfg_kw if cfg_kw is not None else dict(
        max_points=_npad(cs.n_points))


def _jax_errors(cs, tau, keys, cfg_kw=None):
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    import multih_tpu
    from multih_tpu.utils import evaluation

    cfg = multih_tpu.MultiHConfig(**_cfg_kw(cs, cfg_kw))
    npad = cfg.max_points
    f = (multih_tpu.make_fit(cfg) if tau is None
         else multih_tpu.make_fit_tau(cfg))
    args = multih_tpu.pad_points(cs.x1, cs.x2, None, npad)
    out = []
    for k in range(keys):
        res = (f(*args, jax.random.key(k)) if tau is None
               else f(*args, jax.random.key(k), tau))
        out.append(float(evaluation.misclassification_error(
            np.asarray(res.labels)[:cs.n_points], cs.gt_labels,
            cfg.max_labels)))
    return out


def _torch_errors(cs, tau, keys, cfg_kw=None):
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.ops.sampling import TorchDraws
    from multih_tpu_torch.utils import evaluation

    cfg = mt.MultiHConfig(**_cfg_kw(cs, cfg_kw))
    npad = cfg.max_points
    f = (mt.make_fit(cfg, device="cpu") if tau is None
         else mt.make_fit_tau(cfg, device="cpu"))
    args = mt.pad_points(cs.x1, cs.x2, None, npad)
    out = []
    for k in range(keys):
        draws = TorchDraws(torch.Generator().manual_seed(k))
        res = f(*args, draws) if tau is None else f(*args, draws, tau)
        out.append(float(evaluation.misclassification_error(
            res.labels.numpy()[:cs.n_points], cs.gt_labels,
            cfg.max_labels)))
    return out


def _mean_se(xs):
    n = len(xs)
    m = sum(xs) / n
    var = sum((x - m) ** 2 for x in xs) / (n - 1) if n > 1 else 0.0
    return m, math.sqrt(var / n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keys", type=int, default=32)
    ap.add_argument("--scenes", default="easy2_a,med3_a,outlier50_b")
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--json", default="", help="also write the numbers here")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import numpy as np

    from multih_tpu_torch.utils import data

    runners = {"jax": _jax_errors, "torch": _torch_errors}
    packages = args.packages.split(",")
    table = {}
    for name in args.scenes.split(","):
        if name in SYNTHETIC:
            make, cfg_kw = SYNTHETIC[name]
            cs, tau, golden = make(data), None, None
        else:
            cs, cfg_kw = data.suite_scene(name), None
            g = np.load(os.path.join(GOLDENS, f"{name}.npz"))
            tau, golden = float(g["inlier_threshold"]), float(
                g["misclassification"])
        row = table[name] = {"golden": golden, "tau": tau}
        for pkg in packages:
            errs = runners[pkg](cs, tau, args.keys, cfg_kw)
            m, se = _mean_se(errs)
            row[pkg] = dict(mean=m, se=se, errors=errs)
            print(f"{name} {pkg}: mean {m:.4f} pp, s.e. {se:.4f} over "
                  f"{args.keys} keys (golden {golden}); keys 0-2 "
                  f"{', '.join(f'{e:.4f}' for e in errs[:3])}, mean "
                  f"{sum(errs[:3]) / 3:.4f}", flush=True)
        if {"jax", "torch"} <= set(packages):
            a, b = row["jax"], row["torch"]
            z = (b["mean"] - a["mean"]) / max(
                math.hypot(a["se"], b["se"]), 1e-12)
            row["z"] = z
            print(f"{name}: torch - jax = {b['mean'] - a['mean']:+.4f} pp, "
                  f"{z:+.2f} joint standard errors", flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(table, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
