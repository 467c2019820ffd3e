"""models/pipeline: device ms a pair of `sampling_knn` inside the captured
fit's replays, the motion-weighted k-NN graph the sampler draws from
(portbench/stages.py)."""

from portbench import stages


def read(trace):
    return stages.device_ms_per_pair(trace, "sampling_knn")
