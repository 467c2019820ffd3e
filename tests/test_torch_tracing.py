"""utils/tracing.py of the port against the JAX package's: one set of
device spans written as a jax.profiler trace (plugins/profile/<ts>/
<host>.trace.json.gz, the device's "XLA Modules" thread) and as a
torch.profiler one (<worker>.<ts>.pt.trace.json, "cat": "kernel"), read
by both; the same durations, in the same order, and the same medians.
Nothing is compiled or profiled.
"""

import gzip
import json
import os

import pytest

from multih_tpu.utils import tracing as jtracing

from multih_tpu_torch.utils import tracing as ttracing

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
    assert ttracing.median_device_ms(str(tmp_path / "torch"), min_ms,
                                     name_filter) == \
        jtracing.median_device_ms(str(tmp_path / "jax"), min_ms, name_filter)


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
    assert ttracing.median_device_ms(str(tmp_path)) is None
    assert jtracing.median_device_ms(str(tmp_path)) is None
