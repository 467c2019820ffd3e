"""utils/aot: host time a pair in the run's timed window (the call:
copy-in, graph replay, clone and read-back, with the profiler off) over
the device's busy time a pair in the traced sub-window. 1 would mean the
card never waits on the host; only captured cells have it."""


def read(trace):
    busy = trace.busy_s()
    if not trace.captured or busy <= 0 or trace.timed_s_per_pair is None:
        return None
    return trace.timed_s_per_pair / (busy / trace.pairs)
