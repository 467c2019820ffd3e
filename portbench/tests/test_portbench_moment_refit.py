"""The moment refit's per-layer reader
(layer_metrics/kernels.moment_refit.device_ms_per_pair.py)."""

from __future__ import annotations

from pathlib import Path

import pytest

from portbench import run
from portbench import trace as tr

READER = run.load_module(Path(run.HERE) / "layer_metrics"
                         / "kernels.moment_refit.device_ms_per_pair.py")

_ASSEMBLE = ("void (anonymous namespace)::moment_refit_assemble<{}>(float "
             "const*, int, float*, float*)")
_DENORMALIZE = ("void (anonymous namespace)::moment_refit_denormalize<{}>("
                "float const*, float const*, int, float const*, float "
                "const*, float*)")
_K3 = "void (anonymous namespace)::eig_kernel(float const*, int, float*)"


def _trace(device):
    return tr.Trace(pairs=4, host_s=1.0, window=(0.0, 1.0), device=device,
                    ranges=[], annotations=[])


def test_none_without_the_symbol():
    """Nothing to read on a program that refits through K3 and plain ops:
    K3's own symbol, and names that hold a symbol inside a longer
    identifier, are not the refit's kernels."""
    assert READER.read(_trace([])) is None
    assert READER.read(_trace([
        (_K3, 0.1, 0.2),
        ("void at::native::elementwise_kernel", 0.2, 0.3),
        ("xmoment_refit_assemble<0>(float const*)", 0.3, 0.4),
        ("moment_refit_denormalizes(float const*)", 0.4, 0.5)])) is None


def test_sums_the_fused_kernels_events_per_pair():
    got = READER.read(_trace([
        (_ASSEMBLE.format(0), 0.10, 0.13),
        (_K3, 0.13, 0.20),
        (_DENORMALIZE.format(0), 0.20, 0.21),
        (_ASSEMBLE.format(1), 0.30, 0.32),
        (_DENORMALIZE.format(1), 0.40, 0.44)]))
    assert got == pytest.approx((0.03 + 0.01 + 0.02 + 0.04) * 1e3 / 4)


def test_k3_time_keeps_out_of_it():
    """The refit's K3 launches stay K3's: the two ends' symbols hold no
    symbol of trace.ENTRY_POINTS as a whole identifier, and K3's own
    reading is the eigensolve's."""
    for name in (_ASSEMBLE.format(1), _DENORMALIZE.format(0)):
        assert tr.kernel_of_event(name) is None
    assert tr.kernel_of_event(_K3) == "eig9_smallest"
