"""models/pipeline: device ms a pair of `f_accept` inside the captured fit's
replays, the F phases' accept (joint move and one-model fallback); nested,
so its time also counts in f_refine_phases (portbench/stages.py)."""

from portbench import stages


def read(trace):
    return stages.device_ms_per_pair(trace, "f_accept")
