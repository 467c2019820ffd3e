"""Rank programs for the port's mesh tests (test_torch_mesh.py,
test_torch_cli.py), started by multih_tpu_torch.parallel.mesh.spawn.

A module of its own, importing no JAX, so that every spawned rank starts
from a light import; its functions are looked up by name in each rank.
Each case is a pure function of a seed, so the parent process rebuilds
its inputs and its single-device reference without talking to the ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os

import numpy as np
import torch

import multih_tpu_torch as mt
from multih_tpu_torch.models import labeling, pipeline
from multih_tpu_torch.ops.sampling import TorchDraws
from multih_tpu_torch.parallel import sharding
from multih_tpu_torch.utils import data as tdata
from multih_tpu_torch.utils import features

TINY = dict(max_points=128, n_hypotheses=512, n_candidates=64, max_labels=8)

# hyp-sharded fit cases: name -> (config, scene kind, scene seed, key
# seed, extra hypotheses: None, "seeds" (3 seed H's, one not finite: the
# extras are padded to the 'hyp' size) or "affines" (the one-point pool,
# a hypothesis a point, after estimate_fundamental's draws))
FIT_CASES = {
    "tiny_vs1": (TINY, "planes", 2, 11, None),
    "tiny_vs4": (dict(TINY, verify_subsample=4), "planes", 2, 11, None),
    "fundamental": (dict(TINY, model="fundamental", residual="sampson"),
                    "motions", 3, 11, None),
    "window": (dict(max_points=256, agree_block=64, window_sampling=True,
                    n_hypotheses=512, n_candidates=64, max_labels=8),
               "planes", 4, 5, None),
    "seeded": (dict(TINY, verify_subsample=4), "planes", 6, 11, "seeds"),
    "affine": (TINY, "planes", 7, 11, "affines"),
    # the rescore cap with extras: verify_rescore * M = 256 past the
    # 131-hypothesis sampled pool, the 96 one-point H's on top
    "rescore_cap": (dict(TINY, n_hypotheses=128, verify_subsample=4,
                         verify_rescore=4), "planes", 6, 11, "affines"),
}
# (mesh, case) runs: the (1, 4) mesh fits each case on all four ranks;
# the (2, 2) mesh's two rows are separate 'hyp' groups of two, each
# fitting its own case at the same time
HYP4_CASES = ("tiny_vs1", "tiny_vs4", "window", "seeded", "rescore_cap")
HYP2_ROWS = (("tiny_vs1", "fundamental"), ("tiny_vs4", "window"),
             ("seeded", "affine"))

# 'pt' (point) axis cases: name -> (config, scene seed, key seed); 8
# Morton blocks of 64, 2 a rank on the 4-rank mesh, 4 on the 2-rank ones.
# The homography cases fit a 3-plane scene, "fmodel" a 3-motion scene
# (the split move, the exclusive refine, resample-LO and the union merge
# all run). "exact" takes the exact graph, whose far edges a sweep
# gathers; "exact_cut" the same with 16 blocks of 32 and 8 neighbours, so
# that the far list's capacity cuts 214 edges
PT = dict(max_points=512, agree_block=64, n_hypotheses=512, n_candidates=64,
          max_labels=8)
EXACT = dict(PT, knn_window=False, knn_approx=False)
PT_CASES = {
    "plain": (PT, 5, 0),
    "window_vs4": (dict(PT, window_sampling=True, verify_subsample=4), 8, 3),
    "direct": (dict(PT, refit_moments=False), 9, 1),
    "fmodel": (dict(PT, model="fundamental", residual="sampson",
                    inlier_threshold=3.0), 7, 2),
    "exact": (EXACT, 6, 4),
    "exact_cut": (dict(EXACT, agree_block=32, knn_k=8), 6, 4),
}
# (mesh ranks, case) of every 'pt' fit: all four ranks, then the two
# 2-rank meshes at once
PT_RUNS = (((0, 1, 2, 3), "plain"), ((0, 1, 2, 3), "direct"),
           ((0, 1, 2, 3), "fmodel"), ((0, 1, 2, 3), "exact"),
           ((0, 1, 2, 3), "exact_cut"),
           ((0, 1), "plain"), ((2, 3), "window_vs4"),
           ((0, 1), "fmodel"), ((2, 3), "exact"), ((0, 1), "exact_cut"))
# the windowed sweeps' check: N, B, labels, starts, sweeps
PT_SWEEPS = dict(n=512, block=64, labels=9, starts=2, sweeps=4)

MIXED_H = dict(max_points=320, agree_block=128, n_hypotheses=512,
               max_labels=4)
BATCH_TAUS = [3.0, 4.5, 3.0, 3.5, 4.0]


def pt_inputs(case):
    """(x1, x2, valid) numpy, the config, the key seed and the scene of a
    'pt' case: a 3-plane scene of 470 points padded to 512 (30% outliers
    on the exact graph), or a 3-motion one for the F model."""
    cfg, seed, key = PT_CASES[case]
    if cfg.get("model") == "fundamental":
        cs, _ = tdata.synthetic_motion_scene(470, 3, 0.1, 0.5, seed=seed)
    else:
        cs, _ = tdata.synthetic_scene(
            470, 3, 0.1 if cfg.get("knn_window", True) else 0.3, 0.5,
            seed=seed)
    return (mt.pad_points(cs.x1, cs.x2, None, cfg["max_points"]),
            mt.MultiHConfig(**cfg), key, cs)


def pt_sweep_inputs():
    """The windowed sweeps' inputs, numpy: Morton-sorted points of a
    4-plane scene with their valid mask, q0 (L, N) softmax rows, base
    (L, N), int32 starts (S, N) and the inverse temperatures."""
    c = PT_SWEEPS
    cs, _ = tdata.synthetic_scene(c["n"] - 40, 4, 0.2, 0.5, seed=4)
    x1, _, valid = mt.pad_points(cs.x1, cs.x2, None, c["n"])
    perm = pipeline.morton_order(torch.from_numpy(x1),
                                 torch.from_numpy(valid)).numpy()
    rng = np.random.default_rng(12)
    base = rng.uniform(0.0, 4.0, (c["labels"], c["n"])).astype(np.float32)
    q0 = np.exp(-base)
    q0 = (q0 / q0.sum(0)).astype(np.float32)
    starts = rng.integers(0, c["labels"], (c["starts"], c["n"]),
                          dtype=np.int32)
    inv_t = (1.0 / np.geomspace(4.0, 0.5, c["sweeps"])).astype(np.float32)
    return x1[perm], valid[perm], q0, base, starts, inv_t


def pt_sweeps(shard, spatial_weight=0.7):
    """On a 'pt' rank: its window band, then the plain windowed
    mean-field and ICM sweeps (mrf_kernel.mean_field_windowed /
    icm_windowed on a band without its neighbour list: the 'pt' fit's
    sweeps on the CPU) on its own blocks, halos exchanged over the
    mesh."""
    from multih_tpu_torch.ops.kernels import mrf_kernel

    x1, valid, q0, base, starts, inv_t = (torch.from_numpy(a) for a in
                                          pt_sweep_inputs())
    nbr, w = labeling.knn_graph_windowed(x1, valid, 6, shard.block,
                                         (shard.lo, shard.hi))
    adj = labeling.build_window_adjacency(nbr, w, shard)
    own = slice(shard.lo, shard.hi)
    q = mrf_kernel.mean_field_windowed(
        q0[:, own].contiguous(), base[:, own].contiguous(), adj.band, inv_t,
        spatial_weight, shard.window)
    lab = mrf_kernel.icm_windowed(
        starts[:, own].contiguous(), base[:, own].contiguous(), adj.band, 2,
        spatial_weight, shard.window)
    return {"band": adj.band.numpy(), "deg": adj.deg.numpy(),
            "q": q.numpy(), "labels": lab.numpy()}


def pt_f_inputs():
    """The F model's split and union-merge pieces on the "fmodel" case's
    Morton-sorted scene, numpy: x1, x2, valid; the split's (K, N) member
    masks (random labels) and (K, N) residual-like weights; and a union
    merge that fires: the three true F's, motion 1's F again in slot 3,
    motion 1's members split between slots 0 and 3 (members (K, N),
    active (K,), Hs (K, 3, 3))."""
    (x1, x2, valid), cfg, _, cs = pt_inputs("fmodel")
    _, Fs = tdata.synthetic_motion_scene(470, 3, 0.1, 0.5,
                                         seed=PT_CASES["fmodel"][1])
    gt = np.pad(cs.gt_labels, (0, cfg.max_points - cs.n_points))
    perm = pipeline.morton_order(torch.from_numpy(x1),
                                 torch.from_numpy(valid)).numpy()
    x1, x2, valid, gt = x1[perm], x2[perm], valid[perm], gt[perm]
    k, n = cfg.max_labels, cfg.max_points
    rng = np.random.default_rng(13)
    lab = rng.integers(0, k + 1, n)
    member = ((lab[None, :] == np.arange(k)[:, None]) * valid).astype(
        np.float32)
    tk = rng.uniform(0.0, 1.0, (k, n)).astype(np.float32)
    Hs = np.tile(np.eye(3, dtype=np.float32), (k, 1, 1))
    Hs[:3] = Fs
    Hs[3] = Fs[0]
    m_gt = ((gt[None, :] == np.arange(1, k + 1)[:, None]) * valid)
    split = np.arange(n) % 2 == 1
    m_gt[3] = m_gt[0] * split
    m_gt[0] = m_gt[0] * ~split
    active = np.zeros(k, np.float32)
    active[:4] = 1.0
    return dict(x1=x1, x2=x2, valid=valid, member=member, tk=tk, Hs=Hs,
                union_members=m_gt.astype(np.float32), active=active)


def pt_f_pieces(shard, cfg):
    """`_split_weights` and `_union_refit_merge` on pt_f_inputs, with
    `shard` (a 'pt' rank's own points, shard.x1 / x2 / valid every
    point's) or without (every point)."""
    a = {k: torch.from_numpy(v) for k, v in pt_f_inputs().items()}
    thr = torch.tensor(cfg.inlier_threshold ** 2)
    if shard is not None:
        shard.x1, shard.x2, shard.valid = a["x1"], a["x2"], a["valid"]
        own = slice(shard.lo, shard.hi)
        a = {k: (v[..., own] if v.ndim == 2 and v.shape[-1] > 2 else
                 v[own] if k in ("x1", "x2", "valid") else v)
             for k, v in a.items()}
    w = pipeline._split_weights(a["member"], a["x2"] - a["x1"], shard)
    r = pipeline.model_residual_matrix(a["Hs"], a["x1"], a["x2"],
                                       cfg.residual, cfg)
    Hs, active = pipeline._union_refit_merge(
        a["Hs"], a["active"], a["union_members"], r, a["x1"], a["x2"], thr,
        cfg, shard)
    _, score = pipeline._union_scores(
        a["active"], a["union_members"], r, a["x1"], a["x2"], thr,
        dataclasses.replace(cfg, label_cost=1e9), shard)
    return {"split": (w * a["tk"].repeat(12, 1)).numpy(), "Hs": Hs.numpy(),
            "active": active.numpy(), "score": score.numpy()}


def fit_config(case):
    return mt.MultiHConfig(**FIT_CASES[case][0])


def fit_inputs(case):
    """(x1, x2, valid) numpy, the key seed and the fit's keyword
    arguments (seed_Hs or affines) of a hyp-fit case."""
    cfg, kind, seed, key, extras = FIT_CASES[case]
    n = cfg["max_points"]
    if kind == "motions":
        cs, _ = tdata.synthetic_motion_scene(100, 2, 0.1, 0.0, seed=seed)
    else:
        cs, Hs = tdata.synthetic_scene(n - 32, 2, 0.1, 0.5, seed=seed)
    kw = {}
    if extras == "seeds":
        bad = np.full((1, 3, 3), np.nan, np.float32)
        kw["seed_Hs"] = np.concatenate([np.asarray(Hs, np.float32), bad])
    elif extras == "affines":
        aff = features.affines_from_homographies(Hs, cs.gt_labels - 1,
                                                 cs.x1, -1)
        kw["affines"] = np.concatenate(
            [aff, np.tile(np.eye(2, dtype=np.float32), (32, 1, 1))])
    return mt.pad_points(cs.x1, cs.x2, None, n), key, kw


def verification_pool():
    """(Hs (520, 3, 3), x1, x2, valid) numpy: the 2-plane scene's true
    homographies under 260 noise levels each, so counts spread over the
    range and tie often."""
    cs, Hs = tdata.synthetic_scene(96, 2, 0.1, 0.5, seed=0)
    rng = np.random.default_rng(0)
    sig = np.repeat(np.geomspace(1e-5, 3e-2, 260), 2)[:, None, None]
    base = np.stack([np.asarray(Hs[i % 2], np.float64) for i in range(520)])
    pool = base / base[:, 2:3, 2:3] + rng.normal(size=(520, 3, 3)) * sig
    return (pool.astype(np.float32),
            *mt.pad_points(cs.x1, cs.x2, None, 128))


def batch_pairs():
    return [tdata.synthetic_scene(80 + 8 * s, 2, 0.1, 0.5, seed=20 + s)[0]
            for s in range(5)]


def mixed_configs():
    cfg_h = mt.MultiHConfig(**MIXED_H)
    return cfg_h, dataclasses.replace(cfg_h, model="fundamental",
                                      residual="sampson")


def mixed_batch():
    """(x1 (2, N, 2), x2, valid (2, N)) numpy of two mixed scenes."""
    padded = [mt.pad_points(cs.x1, cs.x2, None, MIXED_H["max_points"])
              for cs in (tdata.synthetic_mixed_scene(300, 1, 1, 0.1, 0.5,
                                                     seed=s)[0]
                         for s in (9, 10))]
    return tuple(np.stack([p[j] for p in padded]) for j in range(3))


def _numpy(res):
    """A (nested) NamedTuple of tensors -> {dotted name: array}."""
    out = {}
    for name, v in res._asdict().items():
        if isinstance(v, tuple):
            out.update({f"{name}.{k}": a for k, a in _numpy(v).items()})
        else:
            out[name] = v.cpu().numpy()
    return out


def _save(out_dir, name, rank, arrays):
    np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"), **arrays)


def _layout(mesh_, rank):
    """What a rank sees of a mesh: shape, coordinates, and a gather and a
    sum of its rank number along each axis it is on."""
    out = {"shape": np.array(list(mesh_.shape.values())),
           "coords": np.array(mesh_.coords or (-1, -1))}
    if mesh_.coords is not None:
        t = torch.tensor([rank], dtype=torch.int64)
        for ax in mesh_.axis_names:
            out[f"gather_{ax}"] = mesh_.all_gather(t, ax).numpy()[:, 0]
            out[f"psum_{ax}"] = mesh_.psum(t, ax).numpy()
    return out


def mesh_rank(rank, device, out_dir):
    """Every mesh check of test_torch_mesh.py on a world of 4 CPU ranks;
    each result goes to out_dir/<case>_r<rank>.npz."""
    meshes = {
        "1x4": sharding.make_mesh(pair_axis=1, device=device),
        "1x2": sharding.make_mesh(devices=[0, 1], pair_axis=1,
                                  device=device),
        "2x2": sharding.make_mesh(pair_axis=2, device=device),
        "4x1": sharding.make_mesh(device=device),
    }
    for name, m in meshes.items():
        _save(out_dir, f"mesh_{name}", rank, _layout(m, rank))

    def hyp_fit(mesh_, case):
        (x1, x2, valid), key, kw = fit_inputs(case)
        gen = torch.Generator().manual_seed(key)
        if kw:
            res = mt.fit(x1, x2, valid, gen, fit_config(case), mesh=mesh_,
                         **kw)
        else:
            res = sharding.hyp_sharded_fit(fit_config(case), mesh_)(
                x1, x2, valid, gen)
        return _numpy(res)

    for case in HYP4_CASES:
        _save(out_dir, f"hyp4_{case}", rank, hyp_fit(meshes["1x4"], case))
    row = meshes["2x2"].axis_index("pair")
    for cases in HYP2_ROWS:
        _save(out_dir, f"hyp2_{cases[row]}", rank,
              hyp_fit(meshes["2x2"], cases[row]))

    Hs, x1, x2, valid = verification_pool()
    cfg = mt.MultiHConfig(**TINY)
    pts = [torch.from_numpy(a) for a in (x1, x2, valid)]
    nbr, _ = labeling.knn_graph(pts[0], pts[2], cfg.knn_k)
    c, h, n_ok, ok = pipeline._hypothesize_verify_sharded(
        TorchDraws(torch.Generator().manual_seed(7)), *pts, nbr, cfg, None,
        meshes["1x4"], replication_check=True)
    _save(out_dir, "guard_1x4", rank,
          {"counts": c.numpy(), "hs": h.numpy(), "n_ok": n_ok.numpy(),
           "ok": ok.numpy()})
    for name in ("1x4", "1x2"):
        m = meshes[name]
        if m.coords is None:
            try:
                m.axis_index("hyp")
            except ValueError:
                _save(out_dir, f"verify_{name}", rank, {"refused": True})
            continue
        c, i, ok = sharding.sharded_verification(cfg, m, True)(
            Hs, x1, x2, valid)
        _save(out_dir, f"verify_{name}", rank,
              {"counts": c.numpy(), "idx": i.numpy(), "ok": ok.numpy()})

    pairs = batch_pairs()
    for name in ("4x1", "2x2"):
        res = sharding.run_benchmark_batch(pairs, cfg, seed=3,
                                           taus=BATCH_TAUS,
                                           mesh=meshes[name])
        _save(out_dir, f"batch_{name}", rank, res._asdict())
    res = sharding.run_benchmark_batch(pairs[:2], cfg, seed=3, adaptive=True,
                                       mesh=meshes["2x2"])
    _save(out_dir, "batch_adaptive_2x2", rank, res._asdict())

    cfg_h, cfg_f = mixed_configs()
    res = sharding.sharded_fit_mixed(cfg_h, cfg_f, meshes["2x2"])(
        *mixed_batch(), [torch.Generator().manual_seed(i) for i in (0, 1)])
    _save(out_dir, "mixed_2x2", rank, _numpy(res))

    # the 'pt' axis: every mesh is built by every rank (a collective)
    pt_meshes = {ranks: sharding.make_pt_mesh(ranks, device=device)
                 for ranks, _ in PT_RUNS}
    for ranks, case in PT_RUNS:
        if rank not in ranks:
            continue
        (x1, x2, valid), cfg, key, _ = pt_inputs(case)
        res = sharding.pt_sharded_fit(cfg, pt_meshes[ranks])(
            x1, x2, valid, torch.Generator().manual_seed(key))
        _save(out_dir, f"pt{len(ranks)}_{case}", rank, _numpy(res))
    pt4 = pt_meshes[(0, 1, 2, 3)]
    shard = labeling.PointShard(pt4, PT_SWEEPS["n"], PT_SWEEPS["block"])
    _save(out_dir, "pt4_sweeps", rank, pt_sweeps(shard))
    cfg_f = mt.MultiHConfig(**PT_CASES["fmodel"][0])
    _save(out_dir, "pt4_f_pieces", rank, pt_f_pieces(
        labeling.PointShard(pt4, cfg_f.max_points, cfg_f.agree_block), cfg_f))
    try:  # 512 points are not a multiple of 256 * 4
        sharding.pt_sharded_fit(mt.MultiHConfig(max_points=512), pt4)
        refused = ""
    except ValueError as e:
        refused = str(e)
    _save(out_dir, "pt4_gate", rank, {"refused": refused})
    return rank


def failing_rank(rank, device):
    if rank == 1:
        raise ValueError("this rank fails")
    return rank


def cli_rank(rank, device, argv):
    """`multih_tpu_torch.cli.main(argv)` in a rank: what it printed."""
    from multih_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()
