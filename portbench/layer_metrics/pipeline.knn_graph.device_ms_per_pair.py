"""models/pipeline: device ms a pair of `knn_graph` inside the captured fit's
replays, the k-NN graph of the sorted points (portbench/stages.py)."""

from portbench import stages


def read(trace):
    return stages.device_ms_per_pair(trace, "knn_graph")
