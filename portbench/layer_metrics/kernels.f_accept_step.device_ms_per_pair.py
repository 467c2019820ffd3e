"""ops/kernels: device time of the F accept fallback's two ends per pair,
ms: the kernels whose symbols hold `f_accept_front` or `f_accept_back` as
a whole identifier (csrc/accept_kernel.cu; one fallback step's ends, on
either side of K5, whose time kernels.device_ms_per_pair counts). None
where the trace has no such kernel, as on a program that runs the
fallback in plain ops or a fit that never reaches it (the plane fit)."""

import re

SYMBOL = re.compile(r"(?<![A-Za-z0-9_])f_accept_(?:front|back)"
                    r"(?![A-Za-z0-9_])")


def read(trace):
    total = sum(e - s for name, s, e in trace.device if SYMBOL.search(name))
    return total * 1e3 / trace.pairs if total > 0 else None
