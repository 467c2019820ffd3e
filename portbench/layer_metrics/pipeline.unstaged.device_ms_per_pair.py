"""models/pipeline: device ms a pair of `unstaged` inside the captured fit's
replays, the replay's ops outside every top-level stage (Morton sort,
PEARL's start, the energy trace) (portbench/stages.py)."""

from portbench import stages


def read(trace):
    return stages.device_ms_per_pair(trace, "unstaged")
