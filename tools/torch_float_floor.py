#!/usr/bin/env python3
"""Where float32 alone parts K1 and K6 from their plain versions, held
against float64 on the card.

    python3 tools/torch_float_floor.py [--seeds N]

K1: the affine fit's own verify pool (tests/card_checks.py's, 2563
hypotheses x 512 points, symmetric), counted by the kernel in both
reciprocal modes, by the plain version in float32 and in float64. Each
row where any two differ is printed with its H's singular values; for
the rows of rank ~1 (smallest two singular values below 1e-4 of the
largest) the float64 count is also taken with the adjugate rounded as
an FMA-contracted minor would round it (emulated in float64: each
minor's first product exact, its second rounded to float32, the
difference rounded once), against the adjugate rounded term by term.

K6: the fused front's min(r/thr, 8) at the stress shape (L=17,
N=10240, B=128, tests/card_checks.py's windowed stress scene; 15
near-identity planes with pixel shifts, a wild one), from generators
seeded 0..N-1:
per seed and kind, the largest distance between kernel, plain version
and float64, and how many of the 163840 costs are beyond 1e-4; and r's
largest relative distance from float64 (up to 1e6 px^2) for each. The
float64 residuals come from the same float32 inputs (H's adjugate in
float64).
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _adjugate(h, contracted: bool):
    """(S, 3, 3) float32 H's -> float64 adjugates, each minor rounded to
    float32 as the term-by-term formula rounds it or as an FMA-contracted
    minor does."""
    import torch

    h = h.double().reshape(-1, 9)
    f32 = lambda t: t.float().double()  # noqa: E731

    def minor(i, j, k, l):
        if contracted:
            return f32(h[:, i] * h[:, j] - f32(h[:, k] * h[:, l]))
        return f32(f32(h[:, i] * h[:, j]) - f32(h[:, k] * h[:, l]))

    idx = [(4, 8, 5, 7), (2, 7, 1, 8), (1, 5, 2, 4), (5, 6, 3, 8),
           (0, 8, 2, 6), (2, 3, 0, 5), (3, 7, 4, 6), (1, 6, 0, 7),
           (0, 4, 1, 3)]
    return torch.stack([minor(*m) for m in idx], 1).reshape(-1, 3, 3)


def _transfer_sq(m, a, b):
    from multih_tpu_torch.ops import geometry

    y = geometry.to_homogeneous(a) @ m.transpose(-1, -2)
    return ((y[..., :2] / y[..., 2:]) - b).pow(2).sum(-1)


def k1_pool(dev) -> None:
    import numpy as np
    import torch

    import card_checks as cc
    from multih_tpu_torch.ops.kernels import residual_kernel as rk

    hs, x1, x2, valid, kind, thr = cc.affine_verify_pool(dev)
    t = float(thr)
    counts = {
        "approx": rk.inlier_counts_padded(hs, x1, x2, valid, thr, kind=kind,
                                          approx_rcp=True),
        "exact": rk.inlier_counts_padded(hs, x1, x2, valid, thr, kind=kind,
                                         approx_rcp=False),
        "plain32": rk.inlier_counts_reference(hs, x1, x2, valid, thr, kind),
        "float64": rk.inlier_counts_reference(
            hs.double(), x1.double(), x2.double(), valid.double(),
            thr.double(), kind).float(),
    }
    names = list(counts)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            d = (counts[a] - counts[b]).abs()
            print(f"K1 pool {kind} {hs.shape[0]}x{x1.shape[0]}: {a} vs {b}: "
                  f"max |dcount| {float(d.max())}, rows apart "
                  f"{int((d > 0).sum())}")
    stack = torch.stack([counts[k] for k in names])
    apart = torch.nonzero((stack.max(0).values - stack.min(0).values) > 0)
    sv = torch.linalg.svdvals(hs.double())
    sv = sv / sv[:, :1]
    live = valid > 0
    p1, p2 = x1.double(), x2.double()
    for i in apart.flatten().tolist():
        line = (f"  row {i} ({'sampled' if i < 2051 else 'one-point'}): "
                + ", ".join(f"{k} {float(counts[k][i]):.0f}" for k in names)
                + f"; singular values / the largest "
                f"{np.array2string(sv[i].cpu().numpy(), precision=3)}")
        if float(sv[i, 1]) < 1e-4:
            fwd = _transfer_sq(hs[i].double(), p1, p2)
            for label, c in (("term by term", False), ("contracted", True)):
                adj = _adjugate(hs[i:i + 1], c)[0]
                r = fwd + _transfer_sq(adj, p2, p1)
                line += (f"; float64 count with the adjugate rounded "
                         f"{label}: {int(((r < t) & live).sum())}")
        print(line)


def k6_front(dev, seeds: int) -> None:
    import numpy as np
    import torch

    from multih_tpu_torch.ops import geometry
    from multih_tpu_torch.ops.kernels import mrf_kernel as mk
    import card_checks as cc

    l, sw, n_points, n, block, sweeps = 17, 0.1, 10000, 10240, 128, 4
    x1, x2, valid, _, adj = cc.windowed_problem(dev, n_points, n, block)
    thr = torch.tensor(9.0, device=dev)
    inv_t = torch.from_numpy((1.0 / np.geomspace(2.0, 0.25, sweeps))
                             .astype(np.float32)).to(dev)
    cost = lambda r: torch.clamp_max(r.double() / 9.0, 8.0)  # noqa: E731
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        hs = np.eye(3)[None] + rng.normal(0, 0.02, (l - 1, 3, 3))
        hs[:, 0, 2] += rng.normal(0, 5.0, l - 1)
        hs[-1] = rng.normal(0, 1.0, (3, 3))
        hs = torch.from_numpy(hs.astype(np.float32)).to(dev)
        active = torch.ones(l - 1, device=dev)
        active[1] = 0.0
        q0 = torch.softmax(torch.from_numpy(rng.normal(size=(l, n)).astype(
            np.float32)).to(dev), 0)
        h64 = hs.double()
        a64 = geometry.adjugate_3x3(h64)
        p1, p2 = x1.double(), x2.double()
        for kind in ("symmetric", "transfer"):
            args = (q0, x1, x2, valid, adj.deg, hs, active, adj.band, inv_t,
                    thr, sw, 1.0, kind)
            r = mk.mean_field_fused_front(*args, nbr=adj.nbr)[2]
            r_ref = mk.mean_field_fused_front_reference(*args)[2]
            r64 = _transfer_sq(h64, p1, p2)
            if kind == "symmetric":
                r64 = r64 + _transfer_sq(a64, p2, p1)
            ck, cp, c64 = cost(r), cost(r_ref), cost(r64)
            parts = []
            for label, a, b in (("kernel vs plain", ck, cp),
                                ("kernel vs float64", ck, c64),
                                ("plain vs float64", cp, c64)):
                d = (a - b).abs()
                parts.append(f"{label} {float(d.max()):.3g} "
                             f"({int((d > 1e-4).sum())} beyond 1e-4)")
            near = r64 <= 1e6
            for label, a in (("kernel", r), ("plain", r_ref)):
                d = (a.double() - r64).abs() / r64.abs().clamp_min(1e-4)
                parts.append(f"r from float64 (relative, up to 1e6 px^2) "
                             f"{label} {float(d[near].max()):.3g}")
            print(f"K6 front L={l} N={n} seed {seed} {kind}: "
                  + "; ".join(parts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import torch

    if not torch.cuda.is_available():
        print("torch_float_floor: no CUDA device", file=sys.stderr)
        return 1
    from card_checks import card_line
    from multih_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda")
    _build.load()
    k1_pool(dev)
    k6_front(dev, args.seeds)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
