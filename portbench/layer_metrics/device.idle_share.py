"""The device: the share of the profiled window's wall time in which no
kernel, copy or set ran on the card, %. On a captured cell the profiler
slows each graph launch on the host by more than the replay lasts, so
this share there is mostly the profiler's; aot.replay_over_busy reads
the timed path."""


def read(trace):
    w = trace.window_s()
    return 100.0 * (1.0 - trace.busy_s() / w) if w > 0 else None
