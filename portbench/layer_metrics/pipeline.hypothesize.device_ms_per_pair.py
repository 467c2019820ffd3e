"""models/pipeline: device ms a pair of `hypothesize` inside the captured
fit's replays, sampling and the minimal solves (K2; 8-point F)
(portbench/stages.py)."""

from portbench import stages


def read(trace):
    return stages.device_ms_per_pair(trace, "hypothesize")
