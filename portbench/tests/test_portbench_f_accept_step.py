"""The F accept fallback's per-layer reader
(layer_metrics/kernels.f_accept_step.device_ms_per_pair.py)."""

from __future__ import annotations

from pathlib import Path

import pytest

from portbench import run
from portbench import trace as tr

READER = run.load_module(Path(run.HERE) / "layer_metrics"
                         / "kernels.f_accept_step.device_ms_per_pair.py")

_FRONT = ("(anonymous namespace)::f_accept_front((anonymous namespace)::"
          "Step, int, int)")
_BACK = "(anonymous namespace)::f_accept_back((anonymous namespace)::Step, int)"
_K5 = ("void (anonymous namespace)::icm_grid<1>(int const*, float const*, "
       "int const*, float const*, int const*, int, int, int, int, int, int, "
       "float, int*, int*)")


def _trace(device):
    return tr.Trace(pairs=4, host_s=1.0, window=(0.0, 1.0), device=device,
                    ranges=[], annotations=[])


def test_none_without_the_symbol():
    """Nothing to read on a program that runs the fallback in plain ops:
    K5's own symbol, and names that hold a symbol inside a longer
    identifier, are not the ends."""
    assert READER.read(_trace([])) is None
    assert READER.read(_trace([
        (_K5, 0.1, 0.2),
        ("void at::native::elementwise_kernel", 0.2, 0.3),
        ("xf_accept_front(int)", 0.3, 0.4),
        ("f_accept_backs(int)", 0.4, 0.5)])) is None


def test_sums_the_ends_events_per_pair():
    got = READER.read(_trace([
        (_FRONT, 0.10, 0.13),
        (_K5, 0.13, 0.20),
        (_BACK, 0.20, 0.21),
        (_FRONT, 0.30, 0.32),
        (_BACK, 0.40, 0.44)]))
    assert got == pytest.approx((0.03 + 0.01 + 0.02 + 0.04) * 1e3 / 4)


def test_k5_time_keeps_out_of_it():
    """The fallback's K5 launches stay K5's: the two ends' symbols hold no
    symbol of trace.ENTRY_POINTS as a whole identifier."""
    for name in (_FRONT, _BACK):
        assert tr.kernel_of_event(name) is None
    assert tr.kernel_of_event(_K5) == "icm_fused"
