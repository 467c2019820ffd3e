"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs).

For one cell, in one process on the card, on each seed: the harness's
own run (run.run_cell) for the calls that fill the check's sample, in
place of the window's seconds, judged as every run judges its sample.
With `--control`, the same with the program's matrix products in TF32
(torch.backends.cuda.matmul.allow_tf32 = True after the program has set
it False, before the entry is built): the nearest precision below the
float32 the configurations state. With `--fault`, the entry's outputs
are broken by one of portbench/faults.py's faults.

    python3 -m portbench.calibrate --workload h512.pairs_aot \
        --seeds 12 --first-seed 1000 [--control | --fault NAME]

Prints one JSON line a seed (whether the run came out correct, each
compared number, and every reading of the sample) and, last, the largest
and smallest of each reading over the seeds.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import faults, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=1000)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=faults.FAULTS)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    spec = run.cell_spec(run.load_json(run.ROOT / "BENCHMARK.json"),
                         args.workload)
    # the pipeline's import sets TF32 off; the control sets it on after
    import multih_tpu_torch.models.pipeline  # noqa: F401

    if args.control:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    wrap = None if args.fault is None else (
        lambda entry: faults.Broken(entry, args.fault))
    calls = -(-spec["config"]["check"]["sample"]
              // spec["traffic"]["pairs_per_call"])
    rows = []
    for s in range(args.first_seed, args.first_seed + args.seeds):
        res = run.run_cell(spec, s, 0.0, False, entry_wrap=wrap, calls=calls)
        rows.append(res["readings"])
        print(json.dumps(dict(
            seed=s, control=args.control, fault=args.fault,
            correct=res["correct"],
            compared={k: v["value"] for k, v in res["check"].items()},
            readings=res["readings"])), flush=True)
    keys = sorted(set().union(*rows))
    print(json.dumps({
        "workload": args.workload, "control": args.control,
        "fault": args.fault,
        "tf32": torch.backends.cuda.matmul.allow_tf32,
        "seeds": args.seeds,
        "max": {k: max(r.get(k, float("nan")) for r in rows) for k in keys},
        "min": {k: min(r.get(k, float("nan")) for r in rows)
                for k in keys}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
