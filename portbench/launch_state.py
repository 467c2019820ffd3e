"""The card's state for replaying small kernels, read by a probe graph,
and a wait under the cell's own load until it is the fast one.

An H100 on the benchmark's machines replays a CUDA graph of small
kernels in one of two states: a graph of 2000 one-element adds takes
2.02-2.16 ms in one and 2.77-2.80 ms in the other, and a captured fit
16.9 / 20.7 ms (h512) or 85.0 / 103.7 ms (f512), while the SM clock
(1980 MHz), a spin kernel, a 256 MB copy and a 4096^2 matmul read the
same in both. A run may start in the slow state and leaves it for good
after some seconds under load. A window that opened in it would time an
unknown share of its pairs there. So before the window opens the run
keeps the card busy with the cell's own calls until the probe reads the
fast state, and reports the wait apart from `setup_s`.
"""

from __future__ import annotations

import time

NODES = 2000        # one-element adds in the probe graph
FAST_MS = 2.4       # a probe replay under this is the fast state
IN_A_ROW = 2        # readings in a row that show it
EVERY_S = 0.5       # between readings
LIMIT_S = 60.0      # the longest wait


class Probe:
    """A CUDA graph of `NODES` one-element adds on `device`; `read()`
    times one replay with CUDA events, in ms."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.x = torch.zeros(1, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.x.add_(1)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(NODES):
                self.x.add_(1)
        self.read()

    def read(self) -> float:
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)


def settle(step, device) -> dict:
    """Call `step()` (one of the cell's own calls, results on the host)
    until `IN_A_ROW` probe readings, `EVERY_S` apart, show the fast
    state, or for `LIMIT_S` seconds at most. Returns the seconds, the
    calls, the last reading and whether the fast state was reached."""
    probe = Probe(device)
    t0 = time.perf_counter()
    calls, in_a_row, last = 0, 0, probe.read()
    while time.perf_counter() - t0 < LIMIT_S:
        in_a_row = in_a_row + 1 if last < FAST_MS else 0
        if in_a_row >= IN_A_ROW:
            break
        t_read = time.perf_counter()
        while time.perf_counter() - t_read < EVERY_S:
            step()
            calls += 1
        last = probe.read()
    return {"settle_s": time.perf_counter() - t0, "calls": calls,
            "probe_ms": last, "fast": in_a_row >= IN_A_ROW}
