"""models/pipeline: device ms a pair of `finalize` inside the captured fit's
replays, the last residuals, data costs and ICM labeling (K5)
(portbench/stages.py)."""

from portbench import stages


def read(trace):
    return stages.device_ms_per_pair(trace, "finalize")
