"""What a traced run reads: the launches of the port's kernels with their
shapes, and one torch.profiler session over a short steady sub-window.

`KernelRecorder` wraps the port's kernel entry points (the module
attributes the port calls them through) and records each launch's
kernel and shapes; a captured fit is recorded while it is captured,
since a replay runs no Python. `profile_window` runs a few pairs under
the profiler and returns a `Trace`: the device's activities (kernels,
copies, sets) and the host's ranges, on the profiler's one clock. The
per-layer metric readers (layer_metrics/) take everything from these.
"""

from __future__ import annotations

import bisect
import inspect
import re
import sys
import time
from dataclasses import dataclass, field

# each kernel entry point: (module, attribute, the kernel's symbol in a
# device trace)
ENTRY_POINTS = (
    ("residual_kernel", "inlier_counts_padded", "count_kernel"),
    ("dlt_kernel", "homography_4pt_gt", "dlt_gt"),
    ("eig_kernel", "smallest_eigvec_9x9_batch", "eig_kernel"),
    ("mrf_kernel", "band_list", "band_list"),
    ("mrf_kernel", "mean_field_fused", "mf_grid"),
    ("mrf_kernel", "icm_fused", "icm_grid"),
    ("mrf_kernel", "mean_field_fused_front", "mf_front_grid"),
    ("gather_kernel", "window_gather", "window_gather_kernel"),
)
# the roofline's name of each entry point's kernel
KERNEL_OF = {
    "inlier_counts_padded": "inlier_counts",
    "homography_4pt_gt": "dlt_4pt",
    "smallest_eigvec_9x9_batch": "eig9_smallest",
    "band_list": "band_list",
    "mean_field_fused": "mean_field_fused",
    "icm_fused": "icm_fused",
    "mean_field_fused_front": "mean_field_fused_front",
    "window_gather": "window_gather",
}
SYMBOLS = {KERNEL_OF[attr]: sym for _, attr, sym in ENTRY_POINTS}


_SYMBOL_RE = re.compile(
    r"(?<![A-Za-z0-9_])(" + "|".join(sorted(SYMBOLS.values(), key=len,
                                             reverse=True))
    + r")(?![A-Za-z0-9_])")
_KERNEL_OF_SYMBOL = {sym: kernel for kernel, sym in SYMBOLS.items()}


def kernel_of_event(name: str) -> str | None:
    """The port's kernel whose symbol a device event's name holds (whole,
    as an identifier), or None."""
    m = _SYMBOL_RE.search(name)
    return _KERNEL_OF_SYMBOL[m.group(1)] if m else None


@dataclass
class Launch:
    kernel: str
    shape: dict
    # the neighbour list's counts or the band, whose non-zeros some
    # kernels' work depends on; read once the device has finished
    pairs_of: object = None
    # made while a CUDA graph was being captured (each replay makes it)
    in_capture: bool = False


def _shape(attr: str, a: dict):
    """(shape, tensor to count pairs from) of one call, or None where the
    call launches nothing on the card."""
    if attr == "inlier_counts_padded":
        if a["Hs"].device.type != "cuda":
            return None
        return dict(s=a["Hs"].shape[0], n=a["x1"].shape[0],
                    kind=a.get("kind", "symmetric"),
                    approx_rcp=bool(a.get("approx_rcp", True))), None
    if attr == "homography_4pt_gt":
        if a["gt"].device.type != "cuda":
            return None
        return dict(s=a["gt"].shape[1]), None
    if attr == "smallest_eigvec_9x9_batch":
        if a["ata"].device.type != "cuda":
            return None
        return dict(c=a["ata"].shape[0]), None
    if attr == "band_list":
        nb, block = a["band"].shape[:2]
        return dict(nb=nb, block=block), None
    nbr = a.get("nbr")
    pairs = nbr.cnt if nbr is not None else a["band"]
    if attr == "mean_field_fused":
        if a["inv_temps"].shape[0] == 0:
            return None
        l, n = a["q0_t"].shape
        return dict(l=l, n=n, sweeps=a["inv_temps"].shape[0]), pairs
    if attr == "icm_fused":
        starts, n = a["labels0"].shape
        hs = a.get("half_sweeps")
        halves = 2 * a["iterations"] if hs is None else hs
        if halves <= 0:
            return None
        return dict(starts=starts, l=a["base_t"].shape[0], n=n,
                    half_sweeps=halves), pairs
    if attr == "mean_field_fused_front":
        l, n = a["q0_t"].shape
        return dict(l=l, n=n, sweeps=a["inv_temps"].shape[0],
                    kind=a.get("kind", "symmetric")), pairs
    if attr == "window_gather":
        nb, rows, c = a["win_src"].shape
        return dict(nb=nb, rows=rows, c=c, t=a["sel"].shape[1]), None
    raise KeyError(attr)


class KernelRecorder:
    """Records every launch of the port's kernels while installed. The
    wrappers carry the originals' launch counters (the port's wrappers
    count through their module's name, which is now the wrapper's)."""

    def __init__(self):
        self.launches: list[Launch] = []
        self._saved = []

    def install(self) -> None:
        import importlib

        for mod_name, attr, _ in ENTRY_POINTS:
            mod = importlib.import_module(
                f"multih_tpu_torch.ops.kernels.{mod_name}")
            orig = getattr(mod, attr)
            wrapper = self._wrap(attr, orig)
            for counter in ("launches", "kind_launches"):
                if hasattr(orig, counter):
                    setattr(wrapper, counter, getattr(orig, counter))
            setattr(mod, attr, wrapper)
            self._saved.append((mod, attr, orig))

    def uninstall(self) -> None:
        for mod, attr, orig in reversed(self._saved):
            wrapper = getattr(mod, attr)
            for counter in ("launches", "kind_launches"):
                if hasattr(wrapper, counter):
                    setattr(orig, counter, getattr(wrapper, counter))
            setattr(mod, attr, orig)
        self._saved.clear()

    def _wrap(self, attr, orig):
        import torch

        sig = inspect.signature(orig)
        kernel = KERNEL_OF[attr]

        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            got = _shape(attr, bound.arguments)
            if got is not None:
                self.launches.append(Launch(
                    kernel, got[0], got[1],
                    torch.cuda.is_current_stream_capturing()))
            return orig(*args, **kwargs)

        wrapper.__wrapped__ = orig
        return wrapper


def launch_work(launch: Launch) -> tuple:
    """(bytes, operations, reciprocals) of one recorded launch; the
    device must have finished the work that filled its pair counts."""
    from portbench import roofline

    shape = dict(launch.shape)
    if launch.pairs_of is not None:
        t = launch.pairs_of
        shape["nnz"] = (int((t != 0).sum()) if t.dtype.is_floating_point
                        else int(t.sum()))
    return roofline.WORK[launch.kernel](**shape)


@dataclass
class Trace:
    """One profiled sub-window. Times are seconds on the profiler's
    clock; `window` is the host range of the sub-window on it."""

    pairs: int
    host_s: float                       # host clock across the sub-window
    window: tuple                       # (start, end) on the trace clock
    device: list = field(default_factory=list)   # (name, start, end)
    ranges: list = field(default_factory=list)   # host (name, start, end)
    annotations: list = field(default_factory=list)
    # the port's kernel launches of the window: those the profiled calls
    # made, or for a captured fit those of its capture, which every
    # replay makes again (`launch_repeats` times in the window)
    launches: list = field(default_factory=list)
    launch_repeats: int = 1
    captured: bool = False              # the timed path replays a graph
    # host seconds a pair in the run's timed (unprofiled) window
    timed_s_per_pair: float | None = None

    def busy_intervals(self) -> list:
        """The union of the device's activity inside the window, as
        sorted disjoint (start, end) intervals."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device
                       if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_device_s(self) -> dict:
        """Device seconds of the port's kernels by kernel name."""
        by_name: dict = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        out: dict = {}
        for name, sec in by_name.items():
            k = kernel_of_event(name)
            if k is not None:
                out[k] = out.get(k, 0.0) + sec
        return out

    def top_device_ops(self, n: int = 10) -> list:
        tot: dict = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], sec] for name, sec in top]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time inside the window, summed by what the host
        was doing at each gap's middle: the innermost host range the
        benchmark or the program named (record_function), and the
        outermost operation under way, and listed largest first."""
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        ann = sorted(self.annotations, key=lambda r: r[1])
        tops = []  # outermost host operations, sorted by start
        for name, s, e in sorted(self.ranges, key=lambda r: (r[1], -r[2])):
            if not tops or s >= tops[-1][2]:
                tops.append((name, s, e))
        starts = [t[1] for t in tops]
        tot: dict = {}
        for gs, ge in gaps:
            mid = 0.5 * (gs + ge)
            inner = [a for a in ann if a[1] <= mid < a[2]]
            stage = min(inner, key=lambda a: a[2] - a[1])[0] if inner \
                else "outside any range"
            i = bisect.bisect_right(starts, mid) - 1
            op = tops[i][0] if i >= 0 and tops[i][2] > mid else "no op"
            key = f"{stage} | {op}"
            tot[key] = tot.get(key, 0.0) + (ge - gs)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:160], v] for k, v in top]


WINDOW_RANGE = "portbench.window"


def profile_window(run_pairs, pairs: int, recorder: KernelRecorder | None,
                   captured: bool, tries: int = 3) -> Trace:
    """Run `run_pairs()` (which fits `pairs` pairs and returns when their
    results are on the host) under torch.profiler and read the session.
    A session that comes back without device events is taken again, up to
    `tries` times (a profile can come back empty)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(tries):
        if recorder is not None and not captured:
            recorder.launches.clear()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with record_function(WINDOW_RANGE):
                run_pairs()
                torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        device, ranges, annotations, window = [], [], [], None
        # the session's raw events (torch's own parse of them into a tree
        # takes minutes for a window of graph replays)
        events = prof.profiler.kineto_results.events()
        base = min((e.start_ns() for e in events), default=0)
        for e in events:
            name = e.name()
            s = (e.start_ns() - base) / 1e9
            t = (e.start_ns() - base + e.duration_ns()) / 1e9
            user = bool(getattr(e, "is_user_annotation", bool)())
            named = name.startswith("portbench.") or name in STAGE_NAMES
            if e.device_type() == DeviceType.CUDA:
                if not (user or named):
                    device.append((name, s, t))
            elif name == WINDOW_RANGE:
                window = (s, t)
            elif user or named:
                annotations.append((name, s, t))
            else:
                ranges.append((name, s, t))
        print(f"portbench: traced {pairs} pairs in {host_s:.3f} s; the "
              f"session's stop and read took {time.perf_counter() - t1:.3f}"
              f" s ({len(device)} device events, {len(ranges)} host ops)",
              file=sys.stderr)
        if device and window is not None:
            break
    if not device or window is None:
        raise RuntimeError("the profiler saw no device activity in the "
                           "traced window")
    launches = [] if recorder is None else [
        x for x in recorder.launches if x.in_capture == captured]
    return Trace(pairs=pairs, host_s=host_s, window=window, device=device,
                 ranges=ranges, annotations=annotations, launches=launches,
                 launch_repeats=pairs if captured else 1,
                 captured=captured)


# the record_function ranges of the port's fit (models/pipeline.py)
STAGE_NAMES = frozenset((
    "knn_graph", "banded_adjacency", "sampling_knn", "affine_pool",
    "hypothesize", "verify", "lo_refine", "select", "pearl",
    "split_refine", "union_refit_merge", "f_refine_phases", "finalize"))
