"""The fit's stage spans, and device times from a torch.profiler trace.

`stage(name)` marks one stage of a fit (models/pipeline.py,
models/mixed.py): a ``torch.profiler.record_function`` range of the JAX
``named_scope``'s name, which an eager profile shows. A CUDA graph replay
runs no Python, so while a fit is captured (utils/aot.CapturedFit) the
stages are also recorded as spans of a `StageTable`: each span's device
ops as indices into the graph's kernel, copy and set nodes in capture
order, which are the ops every replay runs in that order. A profile of a
replay maps its i-th device op onto the spans by that index.

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

import contextlib
import glob
import gzip
import json
import os
from dataclasses import dataclass, field
from typing import Callable

from torch.profiler import record_function

# the table of the capture under way (`capture_table`), else None
_table = None


@dataclass
class Span:
    """One stage entered during a capture: its name, the index of the
    span it opened inside (None at the top), its device ops as graph-node
    indices [first, end), and the launches of each of the port's kernels
    inside it (the difference of utils/aot._launches() across it)."""

    name: str
    parent: int | None
    first: int
    end: int | None = None
    launches: dict = field(default_factory=dict)


class StageTable:
    """The stage spans of one captured fit, in the order they opened, and
    `ops`, the graph's device ops in all (set when the capture's body
    ends). `count_ops()` reads the device ops captured so far and
    `count_launches()` the kernels' launch counters."""

    def __init__(self, count_ops: Callable[[], int],
                 count_launches: Callable[[], dict]):
        self.spans: list[Span] = []
        self.ops: int | None = None
        self._count_ops = count_ops
        self._count_launches = count_launches
        self._open: list[int] = []

    @contextlib.contextmanager
    def span(self, name: str):
        parent = self._open[-1] if self._open else None
        span = Span(name, parent, self._count_ops())
        before = self._count_launches()
        self._open.append(len(self.spans))
        self.spans.append(span)
        try:
            yield span
        finally:
            self._open.pop()
            span.end = self._count_ops()
            span.launches = {k: v - before.get(k, 0)
                             for k, v in self._count_launches().items()}


@contextlib.contextmanager
def capture_table(count_ops: Callable[[], int],
                  count_launches: Callable[[], dict]):
    """Open a `StageTable` that every `stage` entered inside records a span
    in; yields the table, whose `ops` is read as the body ends."""
    global _table
    table, prev = StageTable(count_ops, count_launches), _table
    _table = table
    try:
        yield table
        table.ops = count_ops()
    finally:
        _table = prev


@contextlib.contextmanager
def stage(name: str):
    """One stage of a fit: a record_function range of `name`, and a span of
    the capture table when one is open (`capture_table`). Without one it
    reads nothing of the device."""
    table = _table
    with record_function(name):
        if table is None:
            yield
        else:
            with table.span(name):
                yield


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
