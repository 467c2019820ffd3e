"""ops/kernels: device time of the port's CUDA kernels (K1-K7 and the
neighbour list, by their symbols in the trace) per pair, ms."""


def read(trace):
    total = sum(trace.kernel_device_s().values())
    return total * 1e3 / trace.pairs if total > 0 else None
