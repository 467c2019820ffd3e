"""models/pipeline: device ms a pair of `f_refine_phases` inside the captured
fit's replays, the F model's exclusive-core and resample-LO phases
(portbench/stages.py)."""

from portbench import stages


def read(trace):
    return stages.device_ms_per_pair(trace, "f_refine_phases")
