"""utils/tracing.py of the port: its trace reader against the JAX
package's, and the fit's stage spans.

The reader: one set of device spans written as a jax.profiler trace
(plugins/profile/<ts>/<host>.trace.json.gz, the device's "XLA Modules"
thread) and as a torch.profiler one (<worker>.<ts>.pt.trace.json, "cat":
"kernel"), read by both; the same durations, in the same order.

The stages: `stage` nests, records parents, device-op index ranges and
launch differences while a capture table is open (with fake counters:
graphs are captured only on a card), records nothing and reads nothing
of the device without one, and a CPU fit emits the stage ranges it
emitted before the spans, plus `f_accept` on the F model. A captured
call's host steps are ranges only while a profiler records.
"""

import collections
import contextlib
import dataclasses
import gzip
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import multih_tpu_torch as mt
from multih_tpu.utils import tracing as jtracing
from multih_tpu_torch.ops.kernels import _build
from multih_tpu_torch.utils import aot
from multih_tpu_torch.utils import data as tdata
from multih_tpu_torch.utils import tracing as ttracing

torch.set_num_threads(1)

# (name, duration us) of the device spans, and host spans that neither
# reader may count
SPANS = [("jit_fit", 1520.0), ("jit_convert", 12.0), ("jit_fit", 1490.5),
         ("jit_threefry", 48.0), ("jit_fit_refine", 730.25),
         ("jit_fit", 1604.0), ("jit_tiny", 51.0)]
HOST = [("host_dispatch", 900.0), ("jit_fit", 800.0)]


def write_jax_trace(root):
    """The layout jax.profiler.trace writes: the device spans on the
    device pid's "XLA Modules" thread, the host spans elsewhere."""
    d = os.path.join(root, "plugins", "profile", "2026_01_01_00_00_00")
    os.makedirs(d)
    meta = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 2,
         "args": {"name": "XLA Modules"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 3,
         "args": {"name": "XLA Ops"}},
        {"ph": "M", "name": "process_name", "pid": 7,
         "args": {"name": "/host:CPU"}},
    ]
    spans = [{"ph": "X", "pid": 1, "tid": 2, "name": n, "ts": 10.0 * i,
              "dur": dur} for i, (n, dur) in enumerate(SPANS)]
    spans += [{"ph": "X", "pid": 1, "tid": 3, "name": "fusion.1", "ts": 0,
               "dur": 5000.0}]
    spans += [{"ph": "X", "pid": 7, "tid": 1, "name": n, "ts": 0, "dur": dur}
              for n, dur in HOST]
    with gzip.open(os.path.join(d, "host0.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": meta + spans}, f)


def write_torch_trace(root, gz):
    """The layout torch.profiler.tensorboard_trace_handler writes: device
    kernels as "cat": "kernel" events beside CPU ops and runtime calls."""
    events = [{"ph": "X", "cat": "kernel", "name": n, "pid": 0, "tid": 7,
               "ts": 10.0 * i, "dur": dur}
              for i, (n, dur) in enumerate(SPANS)]
    events += [{"ph": "X", "cat": "cpu_op", "name": n, "pid": 100,
                "tid": 100, "ts": 0, "dur": dur} for n, dur in HOST]
    events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "pid": 100, "tid": 100, "ts": 0, "dur": 4000.0},
               {"ph": "i", "cat": "kernel", "name": "jit_fit", "pid": 0,
                "tid": 7, "ts": 0}]
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "rank0.1700000000000.pt.trace.json")
    if gz:
        with gzip.open(path + ".gz", "wt") as f:
            json.dump({"traceEvents": events}, f)
    else:
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("min_ms,name_filter", [
    (0.05, None), (0.0, None), (1.0, None), (0.05, "jit_fit"),
    (0.0, "refine"), (10.0, None)])
def test_same_times_as_jax_reader(tmp_path, gz, min_ms, name_filter):
    write_jax_trace(tmp_path / "jax")
    write_torch_trace(tmp_path / "torch", gz)
    want = jtracing.module_device_times_ms(str(tmp_path / "jax"), min_ms,
                                           name_filter)
    got = ttracing.module_device_times_ms(str(tmp_path / "torch"), min_ms,
                                          name_filter)
    assert got == want


def test_reads_the_newest_trace(tmp_path):
    write_torch_trace(tmp_path, False)
    newer = tmp_path / "nested" / "rank1.1800000000000.pt.trace.json"
    newer.parent.mkdir()
    newer.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 250.0}]}))
    old = tmp_path / "rank0.1700000000000.pt.trace.json"
    os.utime(old, (1.0, 1.0))
    assert ttracing.module_device_times_ms(str(tmp_path)) == [0.25]


def test_empty_directory(tmp_path):
    assert ttracing.module_device_times_ms(str(tmp_path)) == []
    assert jtracing.median_device_ms(str(tmp_path)) is None


class FakeCounters:
    """Stands in for the capturing stream's node count and the kernels'
    launch counters, moved by hand between stages."""

    def __init__(self, ops=0):
        self.n_ops = ops
        self.counts = {"inlier_counts": 0, "icm_fused": 0}

    def ops(self):
        return self.n_ops

    def launches(self):
        return dict(self.counts)


def test_stage_nests_and_records_parents():
    c = FakeCounters()
    with ttracing.capture_table(c.ops, c.launches) as table:
        with ttracing.stage("a"):
            with ttracing.stage("b"):
                pass
            with ttracing.stage("c"):
                with ttracing.stage("d"):
                    pass
        with ttracing.stage("e"):
            pass
    assert [(s.name, s.parent) for s in table.spans] == [
        ("a", None), ("b", 0), ("c", 0), ("d", 2), ("e", None)]
    assert ttracing._table is None


def test_spans_hold_op_ranges_and_launch_differences():
    c = FakeCounters(ops=3)
    with ttracing.capture_table(c.ops, c.launches) as table:
        with ttracing.stage("outer"):
            c.n_ops += 2
            c.counts["inlier_counts"] += 1
            with ttracing.stage("inner"):
                c.n_ops += 4
                c.counts["icm_fused"] += 2
            c.n_ops += 1
        c.n_ops += 7
    outer, inner = table.spans
    assert (outer.first, outer.end) == (3, 10)
    assert (inner.first, inner.end) == (5, 9)
    assert outer.launches == {"inlier_counts": 1, "icm_fused": 2}
    assert inner.launches == {"inlier_counts": 0, "icm_fused": 2}
    assert table.ops == 17


def test_a_failed_body_closes_its_spans_and_the_table():
    c = FakeCounters()
    with pytest.raises(RuntimeError, match="inside"):
        with ttracing.capture_table(c.ops, c.launches) as table:
            with ttracing.stage("outer"):
                c.n_ops += 2
                raise RuntimeError("inside")
    assert [(s.name, s.first, s.end) for s in table.spans] == [
        ("outer", 0, 2)]
    assert table.ops is None and ttracing._table is None


def test_stage_outside_a_capture_records_nothing_and_reads_no_device(
        monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("stage() reached the device")

    for mod, name in ((torch.cuda, "current_stream"),
                      (torch.cuda, "is_current_stream_capturing"),
                      (torch.cuda, "synchronize"), (_build, "load"),
                      (aot, "_graph_ops"), (aot, "_launches")):
        monkeypatch.setattr(mod, name, refused)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttracing.stage("outer"), ttracing.stage("inner"):
            pass
    assert ttracing._table is None and aot.stage_tables() == []
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert sorted(names) == ["inner", "outer"]


def test_aot_steps_are_ranges_only_while_a_profiler_records(monkeypatch):
    """A captured call's host steps (aot.copy_in, aot.replay, aot.clone)
    are record_function ranges under the profiler and enter nothing
    without it."""
    entered = []

    def counting(name):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(aot, "record_function", counting)
    with aot._step("aot.copy_in"):
        pass
    assert entered == []
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in ("aot.copy_in", "aot.replay", "aot.clone"):
            with aot._step(name):
                pass
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert sorted(names) == ["aot.clone", "aot.copy_in", "aot.replay"]


SMALL = mt.MultiHConfig(max_points=128, n_hypotheses=256)
F_SMALL = dataclasses.replace(SMALL, model="fundamental", residual="sampson")
# the ranges the CPU fit emitted before the stage spans (first appearance
# order, and how often), for each model
BEFORE = {
    "homography": {"knn_graph": 1, "sampling_knn": 1, "hypothesize": 1,
                   "verify": 1, "lo_refine": 1, "select": 1, "pearl": 1,
                   "finalize": 1},
    "fundamental": {"knn_graph": 1, "sampling_knn": 1, "hypothesize": 1,
                    "verify": 1, "lo_refine": 1, "select": 1, "pearl": 1,
                    "union_refit_merge": 12, "split_refine": 1,
                    "f_refine_phases": 1, "finalize": 1},
}
# f_exclusive_iterations + f_resample_iterations accepts
F_ACCEPTS = F_SMALL.f_exclusive_iterations + F_SMALL.f_resample_iterations


def _small_fit(cfg):
    make = (tdata.synthetic_scene if cfg.model == "homography"
            else tdata.synthetic_motion_scene)
    cs, _ = make(100, 2, 0.1, 0.5, seed=5)
    scene = mt.pad_points(cs.x1, cs.x2, None, cfg.max_points)
    return mt.fit(*scene, torch.Generator().manual_seed(0), cfg,
                  device="cpu")


@pytest.mark.parametrize("cfg", [SMALL, F_SMALL], ids=["H", "F"])
def test_cpu_fit_emits_the_same_ranges_plus_f_accept(cfg):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _small_fit(cfg)
    events = sorted(prof.profiler.kineto_results.events(),
                    key=lambda e: e.start_ns())
    names = [e.name() for e in events if e.is_user_annotation()]
    want = dict(BEFORE[cfg.model])
    if cfg.model == "fundamental":
        want["f_accept"] = F_ACCEPTS
    assert collections.Counter(names) == collections.Counter(want)
    first = list(dict.fromkeys(names))
    assert [n for n in first if n != "f_accept"] == list(BEFORE[cfg.model])
    if cfg.model == "fundamental":
        assert first.index("f_accept") == first.index("f_refine_phases") + 1


def test_cpu_fit_in_a_capture_table_nests_its_stages():
    """The F fit's spans under a table whose op counter ticks on every
    read: the eager fit's names, each nested stage under its parent, and
    every range inside its parent's."""
    ticks = iter(range(10**6))
    with ttracing.capture_table(lambda: next(ticks), dict) as table:
        _small_fit(F_SMALL)
    spans = table.spans
    parents = collections.Counter(
        (s.name, None if s.parent is None else spans[s.parent].name)
        for s in spans)
    assert parents["f_accept", "f_refine_phases"] == F_ACCEPTS
    assert parents["union_refit_merge", "pearl"] \
        + parents["union_refit_merge", "split_refine"] == 12
    top = [s.name for s in spans if s.parent is None]
    assert top == [n for n in BEFORE["fundamental"]
                   if n != "union_refit_merge"]
    for s in spans:
        assert s.first < s.end <= table.ops
        if s.parent is not None:
            p = spans[s.parent]
            assert p.first < s.first and s.end < p.end
