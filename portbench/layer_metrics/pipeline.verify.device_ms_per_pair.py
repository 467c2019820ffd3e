"""models/pipeline: device ms a pair of `verify` inside the captured fit's
replays, the count sweep (K1) and the top-M pick (portbench/stages.py)."""

from portbench import stages


def read(trace):
    return stages.device_ms_per_pair(trace, "verify")
