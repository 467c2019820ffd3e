#!/usr/bin/env python3
"""The mesh axes across cards: one NCCL rank a card.

Run from the repository root on a host with 4 cards:

    python3 tools/torch_mesh_cards.py            # 4 ranks, NCCL
    python3 tools/torch_mesh_cards.py --parts pt # the 'pt' case alone

or, as a rehearsal on the CPU at a small size:

    python3 tools/torch_mesh_cards.py --device cpu --small

Each rank fits, in turns (single, sharded, sharded, single), the parts
asked for (`--parts`, all three by default):
  - the stress cell (tests/card_checks.py's stress scene and config) on
    its own card alone, and hyp-sharded over a (1, world) mesh; checks
    the sharded result equals the single card fit; reports the warm
    walls, the hypothesize + verify device ms (utils/tracing.py: all
    kernels, and the NCCL kernels among them) and the bytes staged
    through the host;
  - the 24 golden scenes at N=1024 (phase 10's batch) without a mesh on
    rank 0's card, and split over a (world, 1) mesh; checks every pair
    equal; reports both walls;
  - pt: the stress cell with its points split over a (pt=world) mesh,
    N / world points a card (20 Morton blocks of 128 at world 4), halos
    exchanged by NCCL sends and receives, against the single card fit;
    reports the labels that differ from it, the
    warm walls, each rank's launches of K1, K3, K4 and K5, its peak
    allocated memory beside the single fit's and the host-staged bytes.
    (Labels and active equal to the single card fit and the energy
    within rtol 1e-3 are checked.)
Prints one JSON line per rank, then the card line from nvidia-smi.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _wall_ms(fn, device) -> float:
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3


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
    raise AssertionError(f"{worker}: the trace held no device kernel")


def pt_part(rank, device, cfg, args, gen):
    """The 'pt' case: the stress cell on a (pt=world) mesh against this
    card's single fit."""
    import torch
    import torch.distributed as dist

    import card_checks as cc
    import multih_tpu_torch as mt
    from multih_tpu_torch.parallel import sharding

    pt = sharding.make_pt_mesh(device=device)
    f = sharding.pt_sharded_fit(cfg, pt)

    def single():
        return mt.fit(*args, gen.manual_seed(0), cfg)

    def sharded():
        return f(*args, gen.manual_seed(0))

    def peak(fn):
        _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        res = fn()
        _sync(device)
        return res, (torch.cuda.max_memory_allocated(device)
                     if device.type == "cuda" else 0)

    ref, single_peak = peak(single)
    dist.barrier()
    pt.host_staged = 0
    if device.type == "cuda":
        got, launches = cc.count_launches(
            f"pt rank {rank}", ("inlier_counts", "eig9_smallest",
                                "mean_field_fused", "icm_fused"),
            lambda: peak(sharded),
            quiet=True)
        got, sharded_peak = got
    else:
        (got, sharded_peak), launches = peak(sharded), {}
    n_diff = int((ref.labels != got.labels).sum())
    gap = abs(float(got.energy) - float(ref.energy)) / abs(float(ref.energy))
    if not torch.equal(ref.active, got.active) or gap > 1e-3 or n_diff:
        raise AssertionError(f"rank {rank}: pt fit {n_diff} labels, energy "
                             f"gap {gap}, active {got.active.tolist()}")
    out = dict(planes=int(got.active.sum()), labels_differing=n_diff,
               energy_gap=gap,
               launches=launches, staged_bytes=pt.host_staged,
               peak_bytes=dict(single=single_peak, sharded=sharded_peak))
    walls = {"single": [], "sharded": []}
    for turn in ("single", "sharded", "sharded", "single") * 3:
        dist.barrier()
        walls[turn].append(_wall_ms(single if turn == "single" else sharded,
                                    device))
    out["wall_ms"] = walls
    return out


def hyp_part(rank, device, cfg, args, gen, hyp, trace_dir):
    """The stress cell hyp-sharded over a (1, world) mesh against this
    card's single fit."""
    import torch
    import torch.distributed as dist

    import card_checks as cc
    import multih_tpu_torch as mt
    from multih_tpu_torch.parallel import sharding

    def single():
        return mt.fit(*args, gen.manual_seed(0), cfg)

    sharded_fit = sharding.hyp_sharded_fit(cfg, hyp)

    def sharded():
        return sharded_fit(*args, gen.manual_seed(0))

    ref, got = single(), sharded()
    for k in ("labels", "active", "n_hypotheses_ok", "homographies"):
        if not torch.equal(getattr(ref, k), getattr(got, k)):
            raise AssertionError(f"rank {rank}: sharded {k} differs")
    out = dict(planes=int(got.active.sum()))
    walls = {"single": [], "sharded": []}
    for turn in ("single", "sharded", "sharded", "single") * 3:
        dist.barrier()
        walls[turn].append(_wall_ms(single if turn == "single" else sharded,
                                    device))
    out["stress_wall_ms"] = walls
    hyp.host_staged = 0
    sharded()
    out["stress_staged_bytes"] = hyp.host_staged
    if device.type == "cuda":
        xs = cc.hv_inputs(cfg, *args)
        from multih_tpu_torch.models import pipeline
        from multih_tpu_torch.ops.sampling import TorchDraws

        def hv_single():
            return pipeline._hypothesize_verify(
                TorchDraws(gen.manual_seed(0)), *xs, cfg, None, [], [],
                cfg.agree_block)

        def hv_sharded():
            return pipeline._hypothesize_verify_sharded(
                TorchDraws(gen.manual_seed(0)), *xs, cfg, None, hyp,
                window_block=cfg.agree_block)

        dist.barrier()
        out["hv_single"] = _traced_device_ms(hv_single, trace_dir,
                                             f"single{rank}")
        dist.barrier()
        out["hv_sharded"] = _traced_device_ms(hv_sharded, trace_dir,
                                              f"sharded{rank}")
    return out


def batch_part(rank, device, small, pair):
    """The 24 golden scenes split over a (world, 1) mesh against rank 0's
    card alone."""
    import numpy as np
    import torch.distributed as dist

    import card_checks as cc
    import multih_tpu_torch as mt
    from multih_tpu_torch.parallel import sharding

    bcfg = mt.MultiHConfig(max_points=1024)
    css, taus = cc.golden_batch()
    if small:
        css, taus, bcfg = css[:8], taus[:8], dataclasses.replace(
            bcfg, n_hypotheses=512)
    prepared = sharding.prepare_benchmark_batch(css, bcfg, taus=taus,
                                                mesh=pair)
    alone = sharding.prepare_benchmark_batch(css, bcfg, taus=taus,
                                             device=device)

    def batch_single():
        return sharding.run_benchmark_batch(css, bcfg, prepared=alone)

    def batch_sharded():
        return sharding.run_benchmark_batch(css, bcfg, prepared=prepared,
                                            mesh=pair)

    res = batch_sharded()
    bwalls = {"single": [], "sharded": []}
    for turn in ("single", "sharded", "sharded", "single"):
        dist.barrier()
        if turn == "sharded":
            bwalls[turn].append(_wall_ms(batch_sharded, device))
        elif rank == 0:
            ref = batch_single()
            bwalls[turn].append(_wall_ms(batch_single, device))
            for k, a in ref._asdict().items():
                if not np.array_equal(a, getattr(res, k)):
                    raise AssertionError(f"batch {k} differs")
    return dict(batch_wall_ms=bwalls, batch_pairs=len(css))


def rank_main(rank, device, small, trace_dir, parts):
    import torch
    import torch.distributed as dist

    import card_checks as cc
    import multih_tpu_torch as mt
    from multih_tpu_torch.parallel import sharding

    world = dist.get_world_size()
    # every mesh is built by every rank (creating a group is collective)
    hyp = sharding.make_mesh(pair_axis=1, device=device)
    pair = sharding.make_mesh(device=device)
    cfg = cc.stress_cfg()
    if small:
        cfg = dataclasses.replace(cfg, max_points=1024, n_hypotheses=4096,
                                  n_candidates=64)
        from multih_tpu_torch.utils import data

        scene = data.synthetic_scene(1000, 3, 0.3, 0.5, seed=42)[0]
        args = cc.to(device, *mt.pad_points(scene.x1, scene.x2, None, 1024))
    else:
        args = cc.stress_points(device)
    gen = torch.Generator(device=device)
    out = dict(rank=rank, world=world, device=str(device))
    if "hyp" in parts:
        out.update(hyp_part(rank, device, cfg, args, gen, hyp, trace_dir))
    if "batch" in parts:
        out.update(batch_part(rank, device, small, pair))
    if "pt" in parts:
        out["pt"] = pt_part(rank, device, cfg, args, gen)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true",
                    help="a small stress config and 8 batch pairs")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--parts", nargs="+", default=["hyp", "batch", "pt"],
                    choices=("hyp", "batch", "pt"))
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch

    from multih_tpu_torch.parallel import mesh

    if args.device == "cuda":
        if torch.cuda.device_count() < args.world:
            print(f"{torch.cuda.device_count()} cards for {args.world} "
                  f"ranks", file=sys.stderr)
            return 1
        from multih_tpu_torch.ops.kernels import _build

        _build.load()  # one build before the ranks load it
        backend, dev_of = "nccl", None
    else:
        backend, dev_of = "gloo", (lambda r: "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        outs = mesh.spawn(rank_main, args.world, backend, dev_of,
                          timeout_s=900.0, args=(args.small, tmp,
                                                 tuple(args.parts)))
    for o in outs:
        print(json.dumps(o))
    r0 = outs[0]
    walls = {k: r0[k] for k in ("stress_wall_ms", "batch_wall_ms")
             if k in r0}
    if "pt" in r0:
        walls["pt_wall_ms"] = r0["pt"]["wall_ms"]
    for name, w in walls.items():
        print(f"{name}: single median {statistics.median(w['single']):.1f}, "
              f"sharded median {statistics.median(w['sharded']):.1f} "
              f"(runs {w})")
    if args.device == "cuda":
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
