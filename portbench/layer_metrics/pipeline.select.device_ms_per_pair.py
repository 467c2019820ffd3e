"""models/pipeline: device ms a pair of `select` inside the captured fit's
replays, the candidates' residuals and the NMS / coverage pick
(portbench/stages.py)."""

from portbench import stages


def read(trace):
    return stages.device_ms_per_pair(trace, "select")
