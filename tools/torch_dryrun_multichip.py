#!/usr/bin/env python3
"""Every mesh path of the port on n ranks, at tiny shapes, each result
asserted on known synthetic labels: the port's counterpart of
``__graft_entry__.py::dryrun_multichip``.

    python3 tools/torch_dryrun_multichip.py                  # 2 ranks, card
    python3 tools/torch_dryrun_multichip.py --device cpu     # 2 gloo CPU ranks
    python3 tools/torch_dryrun_multichip.py --ranks 4

On n ranks (torch.distributed, started by parallel/mesh.spawn), at the
reference's shapes and bounds:
  1. run_benchmark_batch of n 2-plane scenes on the (n, 1) 'pair' mesh,
     and of n / 2 on the (n / 2, 2) pair x hyp mesh (n >= 2): each pair's
     misclassification < 5%;
  2. sharded_verification of an identity pool on the (1, n) 'hyp' mesh:
     the top-M has n_candidates entries;
  3. hyp_sharded_fit of the fundamental model on a 2-motion scene: 2
     motions, misclassification < 5%;
  4. pt_sharded_fit of the homography model on a 'pt' mesh of all n
     ranks, 4 Morton blocks of 128 a rank: misclassification < 5%;
  5. sharded_fit_mixed of n mixed plane + motion scenes on the 'pair'
     mesh: each misclassification < 10%;
  6. pt_sharded_fit of the fundamental model on the 'pt' mesh, 4 blocks
     a rank, a 2-motion scene: 2 motions, misclassification < 5%.
Every rank returns the same numbers; the tool checks that they agree and
prints one line. The ranks run on the card by default: NCCL with a card
a rank where there are enough cards, else gloo ranks sharing the cards
(gloo copies the gathered tensors through the host); `--device cpu`
runs gloo ranks on the CPU. Exits nonzero if an assertion fails.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = dict(max_points=128, n_hypotheses=512, n_candidates=64, max_labels=8)
F_KW = dict(model="fundamental", residual="sampson", inlier_threshold=3.0)


def _error(labels, gt, k: int) -> float:
    from multih_tpu_torch.utils import evaluation

    return float(evaluation.misclassification_error(labels, gt, k))


def dryrun_rank(rank, device, n: int) -> dict:
    """One rank's share of every path; asserts each result and returns
    the misclassifications."""
    import numpy as np
    import torch

    import multih_tpu_torch as mt
    from multih_tpu_torch.parallel import sharding
    from multih_tpu_torch.utils import data

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    out = {}
    cfg = mt.MultiHConfig(**TINY)
    scenes = [data.synthetic_scene(96, 2, 0.1, 0.5, seed=s)[0]
              for s in range(n)]

    def batch_errors(res, tag, n_pairs):
        assert res.labels.shape == (n_pairs, cfg.max_points), tag
        errs = [_error(res.labels[i][:cs.n_points], cs.gt_labels,
                       cfg.max_labels)
                for i, cs in enumerate(scenes[:n_pairs])]
        assert max(errs) < 5.0, (tag, errs)
        return errs

    mesh = sharding.make_mesh(device=device)
    out["pair"] = batch_errors(sharding.run_benchmark_batch(
        scenes, cfg, seed=0, mesh=mesh), "pair mesh", n)
    if n >= 2:
        mesh2 = sharding.make_mesh(pair_axis=n // 2, device=device)
        n2 = mesh2.shape["pair"]
        out["pair_hyp"] = batch_errors(sharding.run_benchmark_batch(
            scenes[:n2], cfg, seed=0, mesh=mesh2), "pair x hyp mesh", n2)

    mesh_h = sharding.make_mesh(pair_axis=1, device=device)
    x1, x2, valid = mt.pad_points(scenes[0].x1, scenes[0].x2, None,
                                  cfg.max_points)
    s = cfg.n_hypotheses - cfg.n_hypotheses % n
    c_top, _ = sharding.sharded_verification(cfg, mesh_h)(
        np.tile(np.eye(3, dtype=np.float32), (s, 1, 1)), x1, x2, valid)
    assert c_top.shape == (cfg.n_candidates,), c_top.shape
    out["verify_top"] = int(c_top.shape[0])

    def motion_fit(cfg_f, fit, n_points, seed, key):
        cs, _ = data.synthetic_motion_scene(n_points, 2, 0.1, 0.0,
                                            seed=seed)
        xf1, xf2, vf, gt = mt.pad_points(cs.x1, cs.x2, cs.gt_labels,
                                         cfg_f.max_points)
        res = fit(xf1, xf2, vf, gen(key))
        n_motions = int(res.active.sum())
        err = _error(res.labels.cpu().numpy(), gt, cfg_f.max_labels)
        assert n_motions == 2 and err < 5.0, (n_motions, err)
        return dict(motions=n_motions, error=err)

    cfg_f = mt.MultiHConfig(**TINY, **F_KW)
    out["hyp_f"] = motion_fit(cfg_f, sharding.hyp_sharded_fit(cfg_f, mesh_h),
                              100, 3, 11)

    # four Morton blocks a rank, so that only a rank's edge blocks cross
    # the mesh (__graft_entry__.py:211-217)
    n_pt = 128 * 4 * max(2, n)
    cfg_pt = mt.MultiHConfig(max_points=n_pt, n_hypotheses=512,
                             n_candidates=64, max_labels=8, agree_block=128)
    mesh_pt = sharding.make_pt_mesh(device=device)
    cs = data.synthetic_scene(n_pt - 32, 2, 0.1, 0.5, seed=7)[0]
    xp1, xp2, vp, gtp = mt.pad_points(cs.x1, cs.x2, cs.gt_labels, n_pt)
    res = sharding.pt_sharded_fit(cfg_pt, mesh_pt)(xp1, xp2, vp, gen(5))
    out["pt"] = _error(res.labels.cpu().numpy(), gtp, cfg_pt.max_labels)
    assert out["pt"] < 5.0, out["pt"]

    cfg_mh = mt.MultiHConfig(max_points=256, n_hypotheses=512,
                             n_candidates=64, max_labels=4)
    cfg_mf = mt.MultiHConfig(max_points=256, n_hypotheses=512,
                             n_candidates=64, max_labels=4, **F_KW)
    mixed = [data.synthetic_mixed_scene(220, 1, 1, 0.1, 0.5, seed=20 + b)[0]
             for b in range(n)]
    padded = [mt.pad_points(c.x1, c.x2, c.gt_labels, cfg_mh.max_points)
              for c in mixed]
    res = sharding.sharded_fit_mixed(cfg_mh, cfg_mf, mesh)(
        *(np.stack([p[j] for p in padded]) for j in range(3)),
        [gen(31 + b) for b in range(n)])
    k_union = cfg_mh.max_labels + cfg_mf.max_labels
    out["mixed"] = [_error(res.labels[b].cpu().numpy(), p[3], k_union)
                    for b, p in enumerate(padded)]
    assert max(out["mixed"]) < 10.0, out["mixed"]

    cfg_pt_f = mt.MultiHConfig(max_points=n_pt, n_hypotheses=512,
                               n_candidates=64, max_labels=8,
                               agree_block=128, **F_KW)
    out["pt_f"] = motion_fit(cfg_pt_f,
                             sharding.pt_sharded_fit(cfg_pt_f, mesh_pt),
                             n_pt - 32, 3, 5)
    return out


def run(n: int = 2, device: str = "cuda", timeout_s: float = 600.0) -> dict:
    """Spawn n ranks on `device` ("cuda": NCCL with a card a rank where
    there are n cards, else gloo; "cpu": gloo) and return rank 0's
    results, after checking that every rank returned the same."""
    import torch

    from multih_tpu_torch.parallel import mesh

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu")
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= n else "gloo"

        def device_of(r):
            return f"cuda:{r % cards}"
    else:
        backend = "gloo"

        def device_of(r):
            return "cpu"
    outs = mesh.spawn(dryrun_rank, n, backend, device_of, timeout_s,
                      args=(n,))
    for r, o in enumerate(outs):
        if o != outs[0]:
            raise AssertionError(f"rank {r} returned {o}, rank 0 {outs[0]}")
    return dict(outs[0], backend=backend, ranks=n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = run(args.ranks, args.device, args.timeout)

    def pct(xs):
        return "[" + ", ".join(f"{x:.2f}" for x in xs) + "]"

    print(f"torch dryrun_multichip OK: {args.ranks} {out['backend']} ranks "
          f"on {args.device}; pair-mesh miscls % = {pct(out['pair'])}; "
          f"pair x hyp mesh "
          f"{pct(out['pair_hyp']) if 'pair_hyp' in out else 'skipped'}; "
          f"hyp-sharded verification top-{out['verify_top']}; hyp-sharded "
          f"F fit {out['hyp_f']['motions']} motions, miscls "
          f"{out['hyp_f']['error']:.2f}%; pt-sharded fit miscls "
          f"{out['pt']:.2f}%; pair-sharded mixed fit miscls % = "
          f"{pct(out['mixed'])}; pt-sharded F fit "
          f"{out['pt_f']['motions']} motions, miscls "
          f"{out['pt_f']['error']:.2f}% ({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
