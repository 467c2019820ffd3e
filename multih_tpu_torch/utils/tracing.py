"""Device times from a torch.profiler trace.

Counterpart of ``multih_tpu/utils/tracing.py``, which reads the device's
"XLA Modules" spans out of a jax.profiler trace. A torch.profiler trace
written by ``torch.profiler.tensorboard_trace_handler(dir,
worker_name=...)`` is one Chrome-trace file,
``<dir>/<worker>.<timestamp>.pt.trace.json`` (``.gz`` with
``use_gzip=True``); each kernel that ran on the card is one complete
event ("ph": "X") of category "kernel" ("Kernel" in older releases),
its duration in microseconds, free of host overhead and of the gaps
between launches.
"""

from __future__ import annotations

import glob
import gzip
import json
import os


def _newest_trace(trace_dir: str) -> str | None:
    paths = [p for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat),
                                recursive=True)]
    return max(paths, key=lambda p: (os.path.getmtime(p), p), default=None)


def module_device_times_ms(trace_dir: str, min_ms: float = 0.05,
                           name_filter: str | None = None) -> list[float]:
    """Durations (ms) of the device kernels in the newest trace under
    `trace_dir`, in the trace's order. `min_ms` drops the small ones (pass
    0 to keep every kernel); `name_filter` keeps only kernels whose name
    contains the substring."""
    path = _newest_trace(trace_dir)
    if path is None:
        return []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    return [e["dur"] / 1e3 for e in events
            if e.get("ph") == "X" and e.get("cat", "").lower() == "kernel"
            and e.get("dur", 0) / 1e3 >= min_ms
            and (name_filter is None or name_filter in e.get("name", ""))]


def median_device_ms(trace_dir: str, min_ms: float = 0.05,
                     name_filter: str | None = None) -> float | None:
    """Median kernel device time (ms) in the trace, or None if empty."""
    ts = sorted(module_device_times_ms(trace_dir, min_ms, name_filter))
    return ts[len(ts) // 2] if ts else None
