"""Each stage's device time inside a captured fit's replays.

A replay runs no Python, so the stage ranges the eager fit records do not
appear in it. The program records them while it captures the graph
instead (multih_tpu_torch/utils/tracing.StageTable, one a capture, from
`utils/aot.stage_tables()`): each span holds its device ops as indices
into the graph's kernel, copy and set nodes in capture order, and the
table holds their total. This module finds each replay's device ops in a
traced window (`trace.Trace`) and maps them onto the spans:

- the window's device ops, in start order, are the traced calls'
  (`portbench.call`) one after another on one stream: a call's host
  enqueues (launches, copies and sets) before its `cudaGraphLaunch` (the
  copy-in, the generator's seed and offset) come first, then the replay's
  ops, then those of its enqueues after the launch (the clone, the
  read-back). The host's counts split the device's sequence without
  comparing the two clocks: split by the host's call ranges, calls of
  one window showed 5 ops fewer or more than others (`_split` says what
  else it checks);
- op i of a replay belongs to the innermost span whose index range holds
  it, and owns the time in which it ran and no op before it did, so that
  the top-level spans and the ops outside them (`unstaged`) tile the
  replay's device-busy time exactly; a span's time holds its nested
  spans' (inclusive). The idle time between ops belongs to no stage:
  under the profiler the host submits a graph's nodes slower than the
  card runs them (each replay's span is ~2x its busy time, where the
  unprofiled path keeps the card busy), so that idle time is the
  profiler's.

Where the counts do not split the window into replays of one table, no
time is attributed: the readers return None. So does the parent of this
module's program, which records no tables.
"""

from __future__ import annotations

import bisect

CALL = "portbench.call"
GRAPH_LAUNCH = "cudaGraphLaunch"
# host runtime calls that put one op on the stream
ENQUEUES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
            "cudaMemcpy", "cudaMemset")
UNSTAGED = "unstaged"


def _is_enqueue(name: str) -> bool:
    return name.startswith(ENQUEUES)


def replays(trace, tables) -> list | None:
    """(device ops (name, start, end) in start order, table) of each
    traced call's replay; None where the window is not a captured one, a
    call does not show exactly one graph launch, or the window does not
    split into replays of one table (`_split`)."""
    if not trace.captured or not tables:
        return None
    calls = sorted((s, e) for name, s, e in trace.annotations
                   if name == CALL)
    if not calls:
        return None
    host = sorted((s, name) for name, s, _ in trace.ranges
                  if name.startswith(GRAPH_LAUNCH) or _is_enqueue(name))
    host_starts = [h[0] for h in host]
    around = []
    for cs, ce in calls:
        mine = host[bisect.bisect_left(host_starts, cs):
                    bisect.bisect_right(host_starts, ce)]
        launches = [j for j, (_, name) in enumerate(mine)
                    if name.startswith(GRAPH_LAUNCH)]
        if len(launches) != 1:
            return None
        around.append((launches[0], len(mine) - launches[0] - 1))
    device = [(name, s, e) for s, e, name
              in sorted((s, e, name) for name, s, e in trace.device)]
    for total in dict.fromkeys(t.ops for t in tables):
        got = _split(device, around, total)
        if got is not None:
            table = next(t for t in tables if t.ops == total)
            return [(ops, table) for ops in got]
    return None


def _split(device, around, total: int) -> list | None:
    """The replays of `total` ops each in the window's device ops, walked
    from the end: each call's ops after its launch, its replay, its ops
    before the launch. The profiler can lose the records of a session's
    first ops (in one of three motion windows, two of the first call's
    copies in), so ops may be missing before the first call's replay, and
    no op may be left over. Every replay of one graph runs the same ops:
    each call's replay has the last call's op names, but the first
    call's, which is left out where it does not."""
    out, pos = [], len(device)
    for before, after in reversed(around):
        pos -= after
        out.append(device[max(pos - total, 0):max(pos, 0)])
        pos -= total + before
    if pos > 0:
        return None
    out.reverse()
    names = [x[0] for x in out[-1]]
    if len(names) != total or any([x[0] for x in ops] != names
                                  for ops in out[1:]):
        return None
    return out if [x[0] for x in out[0]] == names else out[1:]


def owned_s(ops) -> list:
    """Each op's share of the replay's device-busy time: the part of its
    run in which no op before it ran."""
    reach = float("-inf")
    own = []
    for _, s, e in ops:
        own.append(max(0.0, e - max(reach, s)))
        reach = max(reach, e)
    return own


def attribute(ops, table) -> dict:
    """Device seconds of one replay (its ops, as many as the table's
    total) by span name (inclusive; a name nested in itself counted once)
    and `unstaged`."""
    prefix = [0.0]
    for x in owned_s(ops):
        prefix.append(prefix[-1] + x)
    spans = table.spans
    out: dict = {}
    top = 0.0
    for sp in spans:
        anc, nested = sp.parent, False
        while anc is not None:
            nested |= spans[anc].name == sp.name
            anc = spans[anc].parent
        sec = prefix[sp.end] - prefix[sp.first]
        if not nested:
            out[sp.name] = out.get(sp.name, 0.0) + sec
        if sp.parent is None:
            top += sec
    out[UNSTAGED] = prefix[-1] - top
    return out


def _tables() -> list:
    """The process's capture tables; none from a program without them."""
    from multih_tpu_torch.utils import aot

    tables = getattr(aot, "stage_tables", None)
    return tables() if tables is not None else []


_CACHE: dict = {}


def stage_seconds(trace, tables=None) -> list | None:
    """One dict a replay of device seconds by stage (`attribute`); None
    where the window does not split into replays of one table
    (`replays`). `tables` defaults to the process's captures'."""
    key = id(trace)
    if tables is None and key in _CACHE and _CACHE[key][0] is trace:
        return _CACHE[key][1]
    found = replays(trace, _tables() if tables is None else tables)
    result = None if found is None else [attribute(ops, table)
                                         for ops, table in found]
    if tables is None:
        _CACHE.clear()
        _CACHE[key] = (trace, result)
    return result


def device_ms_per_pair(trace, name: str, tables=None) -> float | None:
    """The stage's device ms a pair: its mean over the replays found, one
    a call, over the pairs a call; None where nothing was attributed or
    no replay ran the stage."""
    per = stage_seconds(trace, tables)
    if not per or all(name not in r for r in per):
        return None
    calls = sum(1 for a in trace.annotations if a[0] == CALL)
    mean = sum(r.get(name, 0.0) for r in per) / len(per)
    return 1e3 * mean * calls / trace.pairs
