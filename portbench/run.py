"""The benchmark of multih_tpu_torch: one cell, one run.

    python3 -m portbench.run --workload h512.pairs_aot --seed 7 \
        --seconds 30 --trace 0

A cell (BENCHMARK.json `workloads`) names a configuration
(portbench/configs/<config>.json: the fit's settings, its scenes and its
reference) and a traffic mix (portbench/traffic/<traffic>.json: the
entry point, portbench/entries/<entry>.py, the pool of pairs and the
pairs a call). The run builds the pool from the seed, warms the entry up
with one untimed call (for a captured entry, the capture), keeps the
card busy with the cell's own calls until it replays small kernels in
its fast state (portbench/launch_state.py), then one caller fits pairs
from the pool, one call in flight, for `--seconds` seconds. With `--trace 1` it then profiles a few more calls and reports
the cell's per-layer metrics (portbench/layer_metrics/<metric>.py);
otherwise its end-to-end metrics (portbench/end_to_end/<metric>.py).
Last, the reference judges a sample of the window's pairs
(portbench/check.py). The last line of standard output is the result.

Without a CUDA device, or with fewer than the cell asks for, the run
exits 1 and prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "multih_tpu")


def _since_process_start() -> float:
    """Seconds since this process started (the kernel's start time on the
    boot clock)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def load_module(path: Path):
    """A reader or entry module by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration and traffic, and the metrics it
    reports, from BENCHMARK.json and the files it names."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]

    def mine(m):
        return workload in m.get("workloads", [workload])

    return dict(
        cell=cell,
        config=load_json(HERE / "configs" / f"{cell['config']}.json"),
        traffic=load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
    )


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's (compared whole: multih_tpu_torch is the port)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


@dataclass
class Window:
    """What the timed window saw."""

    setup_s: float
    pairs_per_call: int
    pairs: int = 0
    attempted: int = 0
    failed: int = 0
    elapsed_s: float = 0.0
    call_ms: list = field(default_factory=list)
    done: list = field(default_factory=list)  # (pool index, outputs)


def call_seed(seed: int, call: int) -> int:
    """The seed of one call's generators, from the run's seed and the
    call's index (31 bits: a batch call adds the pair's index)."""
    ss = np.random.SeedSequence([seed & (2**64 - 1), call])
    return int(ss.generate_state(1)[0] >> 1)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", entry_wrap=None,
             calls: int | None = None) -> dict:
    """One run of a cell on `device`; returns the result object. The
    tests drive it on the CPU at a small size, for a fixed number of
    `calls` in place of the window's seconds, and with `entry_wrap`, a
    broken entry; the command refuses to run without a card."""
    import torch

    from multih_tpu_torch.config import MultiHConfig
    from portbench import check, scenes
    from portbench import trace as tr

    config, traffic = spec["config"], spec["traffic"]
    cfg = MultiHConfig(**config["multih"])
    dev = torch.device(device)
    raw = scenes.make_pool(config["scenes"], traffic["pool"], seed)
    pool = [scenes.pad(s, cfg.max_points) for s in raw]
    per_call = traffic["pairs_per_call"]

    def call_pairs(c: int) -> list[int]:
        return [(c * per_call + j) % len(pool) for j in range(per_call)]

    def inputs(idx):
        return [(raw[i], *pool[i][:3]) for i in idx]

    entry_mod = load_module(HERE / "entries" / f"{traffic['entry']}.py")
    entry = entry_mod.make(cfg, dev, traffic)
    if entry_wrap is not None:
        entry = entry_wrap(entry)
    recorder = tr.KernelRecorder() if trace and dev.type == "cuda" else None

    # warm-up: one untimed call of the cell's own shapes (a captured
    # entry captures here; its launches are recorded while it does)
    if recorder is not None and entry.captured:
        recorder.install()
    entry(inputs(call_pairs(0)), call_seed(seed, 2**32))
    if recorder is not None:
        recorder.uninstall()
    settled = None
    if dev.type == "cuda":
        from portbench import launch_state

        torch.cuda.synchronize(dev)
        # the card brought to its fast state for small kernels under the
        # cell's own calls; this wait is the card's, not the program's
        settled = launch_state.settle(
            lambda: entry(inputs(call_pairs(0)), call_seed(seed, 2**32)),
            dev)
        print(f"portbench: probe {settled['probe_ms']:.4f} ms (fast "
              f"{settled['fast']}) after {settled['settle_s']:.3f} s "
              f"({settled['calls']} calls)", file=sys.stderr)

    win = Window(setup_s=_since_process_start()
                 - (settled["settle_s"] if settled else 0.0),
                 pairs_per_call=per_call)
    t0 = time.perf_counter()
    c = 0
    while (time.perf_counter() - t0 < seconds if calls is None
           else c < calls):
        idx = call_pairs(c)
        win.attempted += len(idx)
        t_call = time.perf_counter()
        try:
            outs = entry(inputs(idx), call_seed(seed, c))
        except Exception as e:  # a failed call ends the window, and counts
            win.failed += len(idx)
            print(f"call {c} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            break
        t_end = time.perf_counter()
        win.call_ms.append((t_end - t_call) * 1e3)
        win.done.extend(zip(idx, outs))
        win.pairs += len(idx)
        win.elapsed_s = t_end - t0
        c += 1

    traced = None
    if trace:
        n_calls = traffic["trace_calls"]

        def run_traced():
            from torch.profiler import record_function

            for j in range(n_calls):
                with record_function("portbench.call"):
                    entry(inputs(call_pairs(c + j)), call_seed(seed, c + j))

        if recorder is not None and not entry.captured:
            recorder.install()
        traced = tr.profile_window(run_traced, n_calls * per_call, recorder,
                                   entry.captured)
        if recorder is not None:
            recorder.uninstall()
        if win.pairs:
            traced.timed_s_per_pair = win.elapsed_s / win.pairs

    result = {"correct": False, "attempted": win.attempted,
              "failed": win.failed, "metrics": {}}
    if trace:
        for m in spec["per_layer"]:
            reader = load_module(HERE / "layer_metrics" / f"{m['name']}.py")
            value = reader.read(traced)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            reader = load_module(HERE / "end_to_end" / f"{m['name']}.py")
            value = reader.read(win) if win.pairs else None
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
    if dev.type == "cuda":
        from portbench import roofline

        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": spec["cell"]["chips"],
            "memory_peak_bytes": torch.cuda.max_memory_allocated(dev),
            "power": roofline.power_limit(), "launch_state": settled}
        if traced is not None:
            result["device"].update(busy_s=traced.busy_s(),
                                    window_s=traced.window_s())
            result["breakdown"] = {"device_ops": traced.top_device_ops(),
                                   "idle_gaps": traced.idle_gaps()}
    else:
        result["device"] = {"platform": dev.type, "count": 1}

    # the entry goes before the reference judges the outputs on the host
    del entry, traced
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ok, compared, readings = check.judge(win.done, pool, config, seed)
    result["correct"] = bool(ok and win.failed == 0 and win.pairs > 0)
    result["readings"] = readings
    result["check"] = compared
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = cell_spec(load_json(ROOT / "BENCHMARK.json"), args.workload)
    import torch

    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {need} CUDA device(s), this "
              f"machine has {have}; no result", file=sys.stderr)
        return 1
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; no result",
              file=sys.stderr)
        return 2
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
