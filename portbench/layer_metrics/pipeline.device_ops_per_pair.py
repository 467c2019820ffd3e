"""models/pipeline and the plain ops under it: device kernels, copies and
sets in the profiled window, per pair. On an eager cell the host
dispatches each of them."""


def read(trace):
    lo, hi = trace.window
    n = sum(1 for _, s, e in trace.device if e > lo and s < hi)
    return n / trace.pairs if n else None
