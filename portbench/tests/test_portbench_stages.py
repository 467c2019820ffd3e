"""The per-stage readers (portbench/stages.py, the pipeline.<stage>.
device_ms_per_pair metrics) on synthetic traced windows of graph
replays: each call's replay found among its copy-in, seed and clone ops
whatever the card's clock reads against the host's, the tiling of its
device-busy time, nested spans counted inclusively, and no number where
the op counts disagree with the capture's table. On the card, the h512
fit captured and replayed under the profiler: every replay's op count is
its table's, the kernels fall in the spans that counted their launches,
and the capture's launches are the eager fit's."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from multih_tpu_torch.utils.tracing import Span
from portbench import run, stages
from portbench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
STAGE_METRICS = [m["name"] for m in BENCH["per_layer"]
                 if m["name"].endswith(".device_ms_per_pair")
                 and m["name"].startswith("pipeline.")]

# one replay's ops: (name, duration, gap before it), in seconds; the
# graph's table spans them as below
REPLAY = [("k_a", 2e-6, 0.0), ("k_b", 3e-6, 1e-6), ("k_c", 1e-6, 2e-6),
          ("Memcpy DtoD", 1e-6, 0.0), ("k_d", 4e-6, 1e-6),
          ("k_e", 2e-6, 3e-6), ("k_f", 1e-6, 1e-6)]
SPANS = [Span("first", None, 0, 3), Span("second", None, 3, 6),
         Span("inner", 1, 4, 6), Span("inner_again", 2, 5, 6),
         Span("second", None, 6, 6)]
TABLE = SimpleNamespace(spans=SPANS, ops=len(REPLAY))


def _window(calls=3, replay=REPLAY, launches=1, extra_device=0, skew=0.0,
            drop=None):
    """A traced window of `calls` captured calls, each: three copies in,
    two seed fills (the second starting on the card after the graph's
    launch began on the host), the replay, a clone copy and three copies
    back, with host ops that enqueue nothing between them. `skew` moves
    the card's clock against the host's; `drop` loses that device op."""
    device, ranges, ann = [], [], []
    t = 1.0
    for _ in range(calls):
        cs = t
        host = []
        for i in range(3):
            host.append(("cudaMemcpyAsync", t + i * 1e-5))
            device.append(("Memcpy HtoD (Pageable -> Device)",
                           t + i * 1e-5 + 2e-6, t + i * 1e-5 + 3e-6))
        ranges.append(("aten::copy_", t, t + 3e-5))
        t += 4e-5
        host += [("cudaLaunchKernel", t), ("cudaLaunchKernel", t + 1e-6)]
        device.append(("fill_seed", t + 3e-6, t + 4e-6))
        host.append(("cudaStreamIsCapturing", t + 1.5e-6))
        for j in range(launches):
            host.append(("cudaGraphLaunch", t + 2e-6 + j * 1e-6))
        device.append(("fill_offset", t + 4.5e-6, t + 5e-6))
        d = t + 6e-6
        for name, dur, gap in replay:
            d += gap
            device.append((name, d, d + dur))
            d += dur
        for k in range(extra_device):
            device.append(("stray", d + k * 1e-6, d + k * 1e-6 + 5e-7))
        host += [("cudaMemcpyAsync", t + 8e-6)]
        device.append(("Memcpy DtoD (Device -> Device)", d + 1e-6, d + 2e-6))
        for i in range(3):
            host.append(("cudaMemcpyAsync", t + 9e-6 + i * 1e-6))
            device.append(("Memcpy DtoH (Device -> Pageable)",
                           d + 3e-6 + i * 1e-6, d + 3.5e-6 + i * 1e-6))
        host.append(("cudaStreamSynchronize", t + 2e-5))
        ranges += [(name, s, s + 5e-7) for name, s in host]
        t = d + 1e-4
        ann.append(("portbench.call", cs, t - 5e-5))
    device = [(n, s + skew, e + skew) for n, s, e in device]
    if drop is not None:
        del device[drop]
    return tr.Trace(pairs=calls, host_s=t - 1.0, window=(0.5, t + 1.0),
                    device=device, ranges=ranges, annotations=ann,
                    captured=True)


# each replay op's device time; the gaps between them are nobody's
OWN = [dur for _, dur, _ in REPLAY]
BUSY = sum(OWN)


@pytest.mark.parametrize("skew", [0.0, 3e-4, -3e-4])
def test_replays_are_found_among_the_calls_other_ops(skew):
    """Also with the card's clock off the host's by more than the gap
    between two calls."""
    got = stages.replays(_window(skew=skew), [TABLE])
    assert len(got) == 3
    for ops, table in got:
        assert table is TABLE
        assert [o[0] for o in ops] == [r[0] for r in REPLAY]


def test_ops_tile_the_replay_busy_time():
    (ops, _), = stages.replays(_window(calls=1), [TABLE])
    assert stages.owned_s(ops) == pytest.approx(OWN)
    overlapping = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 1.5, 2.5),
                   ("d", 4.0, 5.0)]
    assert stages.owned_s(overlapping) == pytest.approx([2, 1, 0, 1])


def test_top_level_spans_and_unstaged_sum_to_the_replay_busy_time():
    got = stages.stage_seconds(_window(), tables=[TABLE])
    assert len(got) == 3
    for r in got:
        assert r["first"] == pytest.approx(sum(OWN[0:3]))
        assert r["second"] == pytest.approx(sum(OWN[3:6]))
        assert r["unstaged"] == pytest.approx(OWN[6])
        assert r["first"] + r["second"] + r["unstaged"] == \
            pytest.approx(BUSY)


def test_nested_spans_are_inclusive():
    r = stages.stage_seconds(_window(calls=1), tables=[TABLE])[0]
    assert r["inner"] == pytest.approx(sum(OWN[4:6]))
    assert r["inner_again"] == pytest.approx(OWN[5])
    assert r["second"] > r["inner"] > r["inner_again"]


def test_a_name_nested_in_itself_counts_once():
    spans = [Span("pearl", None, 0, 5), Span("pearl", 0, 1, 3)]
    table = SimpleNamespace(spans=spans, ops=len(REPLAY))
    r = stages.stage_seconds(_window(calls=1), tables=[table])[0]
    assert r["pearl"] == pytest.approx(sum(OWN[0:5]))
    assert r["unstaged"] == pytest.approx(sum(OWN[5:]))


# a call's device ops: 3 copies in, 2 fills, the replay, 1 clone copy and
# 3 copies back
PER_CALL = 5 + len(REPLAY) + 4


@pytest.mark.parametrize("drop,found", [
    (0, 3), (1, 3), (4, 3),          # the first call's copy-in or fills
    (5, 2), (5 + len(REPLAY) - 1, 2),  # in the first call's replay
    (PER_CALL + 4, 2),               # a fill of the second call
])
def test_records_lost_early_in_the_window(drop, found):
    """The profiler can lose the records of the session's first ops: the
    replays that still show whole are found; a first replay cut short,
    or cut off by a later loss, is left out."""
    got = stages.replays(_window(drop=drop), [TABLE])
    assert len(got) == found
    for ops, _ in got:
        assert [o[0] for o in ops] == [r[0] for r in REPLAY]
    assert len(stages.stage_seconds(_window(drop=drop), [TABLE])) == found


@pytest.mark.parametrize("table_ops,window", [
    (len(REPLAY) + 1, {}), (len(REPLAY) - 1, {}),
    (len(REPLAY), {"extra_device": 1}),
    (len(REPLAY), {"drop": PER_CALL + 5 + 2}),   # the second replay's op
    (len(REPLAY), {"drop": 2 * PER_CALL + 6}),   # the last replay's op
    (len(REPLAY), {"drop": PER_CALL + 5 + len(REPLAY) + 1}),  # a copy back
    (len(REPLAY), {"launches": 2}), (len(REPLAY), {"launches": 0})])
def test_no_number_where_the_counts_disagree(table_ops, window):
    table = SimpleNamespace(spans=SPANS, ops=table_ops)
    trace = _window(**window)
    assert stages.stage_seconds(trace, tables=[table]) is None
    assert stages.device_ms_per_pair(trace, "first", tables=[table]) is None


def test_the_replays_take_the_table_of_their_op_count():
    other = SimpleNamespace(spans=[Span("other", None, 0, 2)], ops=2)
    got = stages.stage_seconds(_window(), tables=[other, TABLE])
    assert got is not None and all("first" in r for r in got)


def test_an_eager_window_has_no_replays():
    trace = _window()
    trace.captured = False
    assert stages.replays(trace, [TABLE]) is None


@pytest.mark.parametrize("drop", [None, 5])
def test_device_ms_per_pair(drop):
    """The mean over the replays found, over the pairs a call."""
    trace = _window(calls=4, drop=drop)
    assert stages.device_ms_per_pair(trace, "second", tables=[TABLE]) == \
        pytest.approx(1e3 * sum(OWN[3:6]))
    trace.pairs = 8
    assert stages.device_ms_per_pair(trace, "second", tables=[TABLE]) == \
        pytest.approx(1e3 * sum(OWN[3:6]) / 2)
    assert stages.device_ms_per_pair(trace, "absent", tables=[TABLE]) is None


def test_readers_read_the_processs_tables(monkeypatch):
    """Each metric's file reads through the process's capture tables;
    with none (an eager run, or a program that records no tables) every
    one reads nothing."""
    from multih_tpu_torch.utils import aot

    assert len(STAGE_METRICS) == 13
    trace = _window()
    readers = {m: run.load_module(ROOT / "portbench" / "layer_metrics"
                                  / f"{m}.py") for m in STAGE_METRICS}
    assert all(r.read(trace) is None for r in readers.values())
    monkeypatch.delattr(aot, "stage_tables")
    assert all(r.read(_window()) is None for r in readers.values())
    spans = [Span("knn_graph", None, 0, 2), Span("pearl", None, 2, 6),
             Span("f_accept", 1, 3, 4)]
    monkeypatch.setattr(aot, "stage_tables", lambda: [SimpleNamespace(
        spans=spans, ops=len(REPLAY))], raising=False)
    trace = _window()
    got = {m.split(".")[1]: r.read(trace) for m, r in readers.items()}
    assert {k for k, v in got.items() if v is not None} == {
        "knn_graph", "pearl", "f_accept", "unstaged"}
    assert got["knn_graph"] + got["pearl"] + got["unstaged"] == \
        pytest.approx(1e3 * BUSY)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("graphs are captured only on a card: no CUDA device "
                    "here")
    return torch.device("cuda")


# aot._launches()'s name of each kernel, as trace.kernel_of_event names it
_KERNEL = {"inlier_counts_f": "inlier_counts", "dlt_4pt": "dlt_4pt",
           "eig9_smallest": "eig9_smallest", "band_list": "band_list",
           "mean_field_fused": "mean_field_fused", "icm_fused": "icm_fused",
           "mean_field_fused_front": "mean_field_fused_front",
           "window_gather": "window_gather", "inlier_counts": "inlier_counts"}


@pytest.mark.cuda
def test_captured_h512_replays_map_onto_its_spans(card):
    from torch.profiler import record_function

    from multih_tpu_torch.config import MultiHConfig
    from multih_tpu_torch.models import pipeline
    from multih_tpu_torch.utils import aot
    from portbench import scenes

    config = json.loads((ROOT / "portbench" / "configs" / "h512.json")
                        .read_text())
    cfg = MultiHConfig(**config["multih"])
    pool = [scenes.pad(s, cfg.max_points)
            for s in scenes.make_pool(config["scenes"], 4, 3000000019)]
    fn = aot.cached_fit(cfg, "fit", device=card)
    gen = torch.Generator(device=card)
    fn(*pool[0][:3], gen.manual_seed(1))
    table = fn.stages
    assert table in aot.stage_tables() and table.ops > 0

    def run_pairs():
        for i, p in enumerate(pool):
            with record_function("portbench.call"):
                res = fn(*p[:3], gen.manual_seed(i))
                res.labels.cpu()

    trace = tr.profile_window(run_pairs, len(pool), None, captured=True)
    found = stages.replays(trace, [table])
    assert found is not None and len(found) == len(pool)
    replays = [ops for ops, _ in found]

    for ops in replays:
        kinds = [tr.kernel_of_event(name) for name, _, _ in ops]
        for sp in table.spans:
            counted: dict = {}
            for k, v in sp.launches.items():
                counted[_KERNEL[k]] = counted.get(_KERNEL[k], 0) + v
            seen: dict = {}
            for k in kinds[sp.first:sp.end]:
                if k is not None:
                    seen[k] = seen.get(k, 0) + 1
            assert seen == {k: v for k, v in counted.items() if v}, sp.name

    per = stages.stage_seconds(trace, tables=[table])
    assert per is not None
    for r, ops in zip(per, replays):
        top = sum(v for k, v in r.items()
                  if k == "unstaged" or any(s.name == k and s.parent is None
                                            for s in table.spans))
        assert top == pytest.approx(sum(stages.owned_s(ops)))

    before = aot._launches()
    pipeline.make_fit(cfg, device=card)(*pool[0][:3], gen.manual_seed(1))
    torch.cuda.synchronize(card)
    eager = {k: v - before[k] for k, v in aot._launches().items()}
    assert fn.launches == eager
