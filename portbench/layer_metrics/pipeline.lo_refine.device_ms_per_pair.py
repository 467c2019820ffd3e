"""models/pipeline: device ms a pair of `lo_refine` inside the captured fit's
replays, the LO refits (moment refit, K3) (portbench/stages.py)."""

from portbench import stages


def read(trace):
    return stages.device_ms_per_pair(trace, "lo_refine")
