#!/usr/bin/env python3
"""Each stage's share of a captured fit's replay on the card, and what
recording the stage spans costs.

    python3 tools/torch_stage_spans.py [--configs h512 f512] [--calls 16]
        [--turns 2] [--seed 3000000021]

For each configuration of portbench/configs/ (the benchmark's cells'
fits, `aot.cached_fit(cfg, "fit")`), on one card:
  - the stages: `--calls` replays of distinct pairs under torch.profiler,
    as the benchmark's traced run makes them (one `portbench.call` range
    a call), mapped onto the capture's spans by portbench/stages.py:
    for each stage (nested ones indented) its device ms a pair, its
    device ops a replay (from the table) and its share of the replay's
    device-busy time; that busy time and the replay's span (first op's
    start to last op's end) against the window's busy time a pair; the
    seconds the mapping takes; the breakdown's idle gaps
    (trace.Trace.idle_gaps), which name the call's aot.* host steps;
  - capture cost, after that: the fit captured anew as a `CapturedFit`,
    with the stage table and without it (utils/tracing.capture_table
    replaced by one that opens none), in turns (with, without, without,
    with, ...): `capture_s`, `warmup_s`, the node count's reads and their
    seconds, and whether the launches captured are equal in both.
The host cost a call of the three aot.* steps with the profiler off (and
of three record_function ranges, which they enter only while a profiler
records), over 200,000 calls, first before any profiler session in the
process (as in the benchmark's timed window) and last after them.
One JSON line a configuration and one for the ranges, last, on standard
output; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import stages  # noqa: E402


def _scenes(config: dict, n: int, seed: int):
    from portbench import scenes
    from multih_tpu_torch.config import MultiHConfig

    cfg = MultiHConfig(**config["multih"])
    pool = [scenes.pad(s, cfg.max_points)
            for s in scenes.make_pool(config["scenes"], n, seed)]
    return cfg, pool


@contextlib.contextmanager
def _no_table(count_ops, count_launches):
    yield None


def capture_cost(cfg, pair, dev, turns: int) -> dict:
    """capture_s / warmup_s of fresh captures with and without the stage
    table, in turns."""
    import torch

    from multih_tpu_torch.utils import aot

    real = aot.tracing.capture_table
    got = {"with": [], "without": []}
    order = []
    for t in range(turns):
        order += ["with", "without"] if t % 2 == 0 else ["without", "with"]
    launches = {}
    count_ops = aot._graph_ops
    for side in order:
        counted = {"reads": 0, "s": 0.0}

        def timed(stream):
            t0 = time.perf_counter()
            try:
                return count_ops(stream)
            finally:
                counted["reads"] += 1
                counted["s"] += time.perf_counter() - t0

        aot.tracing.capture_table = real if side == "with" else _no_table
        aot._graph_ops = timed
        try:
            fit = aot.CapturedFit(cfg, "fit", dev)
            fit(*pair, torch.Generator(device=dev).manual_seed(0))
        finally:
            aot.tracing.capture_table = real
            aot._graph_ops = count_ops
        torch.cuda.synchronize(dev)
        got[side].append({"capture_s": fit.capture_s,
                          "warmup_s": fit.warmup_s,
                          "node_count_reads": counted["reads"],
                          "node_count_s": counted["s"]})
        launches[side] = fit.launches
        assert (fit.stages is None) == (side == "without")
        del fit
        torch.cuda.empty_cache()
    return {"order": order, "capture": got,
            "launches_equal": launches["with"] == launches["without"]}


def stage_rows(table, per: list | None, replays: list | None) -> list:
    """(name, depth, device ms a replay, ops a replay, share of the
    replay's device-busy time) for each distinct span name in the order it
    first opened, depth by nesting; the times None without replays."""
    spans = table.spans

    def depth(sp):
        d, p = 0, sp.parent
        while p is not None:
            d, p = d + 1, spans[p].parent
        return d

    names, ops = {}, {}
    for sp in spans:
        names.setdefault(sp.name, depth(sp))
        nested = False
        p = sp.parent
        while p is not None:
            nested |= spans[p].name == sp.name
            p = spans[p].parent
        if not nested:
            ops[sp.name] = ops.get(sp.name, 0) + sp.end - sp.first
    top_ops = sum(sp.end - sp.first for sp in spans if sp.parent is None)
    names["unstaged"], ops["unstaged"] = 0, table.ops - top_ops
    rows = []
    for name, d in names.items():
        if per is None:
            rows.append((name, d, None, ops[name], None))
            continue
        busy_s = sum(sum(stages.owned_s(r)) for r in replays)
        sec = sum(r.get(name, 0.0) for r in per)
        rows.append((name, d, 1e3 * sec / len(per), ops[name],
                     100.0 * sec / busy_s))
    return rows


def stage_profile(cfg, pool, dev, calls: int) -> dict:
    import torch
    from torch.profiler import record_function

    from multih_tpu_torch.utils import aot
    from portbench import trace as tr

    fn = aot.cached_fit(cfg, "fit", device=dev)
    gen = torch.Generator(device=dev)
    fn(*pool[0][:3], gen.manual_seed(0))
    for i in range(8):  # warm replays
        fn(*pool[i % len(pool)][:3], gen.manual_seed(i)).labels.cpu()

    def run_pairs():
        for i in range(calls):
            with record_function("portbench.call"):
                res = fn(*pool[i % len(pool)][:3], gen.manual_seed(100 + i))
                [x.cpu() for x in (res.labels, res.homographies, res.active)]

    trace = tr.profile_window(run_pairs, calls, None, captured=True)
    t0 = time.perf_counter()
    per = stages.stage_seconds(trace, tables=[fn.stages])
    read_s = time.perf_counter() - t0
    found = stages.replays(trace, [fn.stages])
    replays = None if found is None else [ops for ops, _ in found]
    out = {"table_ops": fn.stages.ops, "spans": len(fn.stages.spans),
           "capture_s": fn.capture_s, "launches": fn.launches,
           "mapping_s": read_s, "idle_gaps": trace.idle_gaps(),
           "busy_ms_per_pair": 1e3 * trace.busy_s() / calls,
           "device_ops_per_pair": len(trace.device) / calls}
    rows = stage_rows(fn.stages, per, replays)
    out["stages"] = rows
    if per is not None:
        busy = [sum(stages.owned_s(r)) for r in replays]
        span = [max(e for _, _, e in r) - r[0][1] for r in replays]
        out["replay_busy_ms_per_pair"] = 1e3 * sum(busy) / calls
        out["replay_span_ms_per_pair"] = 1e3 * sum(span) / calls
        out["replay_busy_over_busy"] = out["replay_busy_ms_per_pair"] \
            / out["busy_ms_per_pair"]
        top = {sp.name for sp in fn.stages.spans if sp.parent is None}
        out["top_plus_unstaged_over_replay_busy"] = sum(
            r[2] for r in rows if r[0] in top or r[0] == "unstaged") \
            / out["replay_busy_ms_per_pair"]
    print(f"{'stage':<28}{'ms a pair':>12}{'ops':>9}{'share %':>10}",
          file=sys.stderr)
    for name, d, ms, ops, share in rows:
        ms_s = "-" if ms is None else f"{ms:.4f}"
        sh_s = "-" if share is None else f"{share:.2f}"
        print(f"{'  ' * d + name:<28}{ms_s:>12}{ops:>9}{sh_s:>10}",
              file=sys.stderr)
    return out


def range_cost(n: int = 200_000) -> dict:
    """Host us a call of its three aot.* steps (`aot._step`) with the
    profiler off, and of three plain record_function ranges, each less
    an empty loop of the same length."""
    from torch.profiler import record_function

    from multih_tpu_torch.utils import aot

    def loop(enter):
        t0 = time.perf_counter()
        for _ in range(n):
            with enter("aot.copy_in"):
                pass
            with enter("aot.replay"):
                pass
            with enter("aot.clone"):
                pass
        return time.perf_counter() - t0

    empty = loop(lambda name: contextlib.nullcontext())
    return {"calls": n,
            "us_per_call_aot_steps": 1e6 * (loop(aot._step) - empty) / n,
            "us_per_call_record_function": 1e6 * (loop(record_function)
                                                  - empty) / n}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", nargs="+", default=["h512", "f512"])
    p.add_argument("--calls", type=int, default=16)
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--seed", type=int, default=3000000021)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    from portbench import roofline

    head = {"device": torch.cuda.get_device_name(dev),
            "power": roofline.power_limit(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    print(json.dumps(head), flush=True)
    # the ranges' cost before any profiler session in the process, as in
    # the benchmark's timed window, and again after the sessions below
    cold = range_cost()
    for name in args.configs:
        config = json.loads((ROOT / "portbench" / "configs"
                             / f"{name}.json").read_text())
        cfg, pool = _scenes(config, max(args.calls, 8), args.seed)
        row = {"config": name}
        # the cached capture first: it pays the process's first-time costs
        row.update(stage_profile(cfg, pool, dev, args.calls))
        row.update(capture_cost(cfg, pool[0][:3], dev, args.turns))
        print(json.dumps(row), flush=True)
    print(json.dumps({"aot_ranges": {"before_profiling": cold,
                                     "after_profiling": range_cost()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
