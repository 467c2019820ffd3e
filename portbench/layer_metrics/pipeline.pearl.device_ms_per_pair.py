"""models/pipeline: device ms a pair of `pearl` inside the captured fit's
replays, the PEARL iterations (K4-K6, refits; F: the union refit merge)
(portbench/stages.py)."""

from portbench import stages


def read(trace):
    return stages.device_ms_per_pair(trace, "pearl")
