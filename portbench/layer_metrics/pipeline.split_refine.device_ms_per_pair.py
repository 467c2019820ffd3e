"""models/pipeline: device ms a pair of `split_refine` inside the captured
fit's replays, the F model's split move (portbench/stages.py)."""

from portbench import stages


def read(trace):
    return stages.device_ms_per_pair(trace, "split_refine")
