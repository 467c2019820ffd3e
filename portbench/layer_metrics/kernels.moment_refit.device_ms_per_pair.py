"""ops/kernels: device time of the moment refit's two ends per pair, ms:
the kernels whose symbols hold `moment_refit_assemble` or
`moment_refit_denormalize` as a whole identifier (csrc/refit_kernel.cu;
a batched refit's assembly and denormalization, on either side of K3,
whose time kernels.device_ms_per_pair counts). None where the trace has
no such kernel, as on a program that refits through plain ops around
K3."""

import re

SYMBOL = re.compile(r"(?<![A-Za-z0-9_])moment_refit_(?:assemble|denormalize)"
                    r"(?![A-Za-z0-9_])")


def read(trace):
    total = sum(e - s for name, s, e in trace.device if SYMBOL.search(name))
    return total * 1e3 / trace.pairs if total > 0 else None
