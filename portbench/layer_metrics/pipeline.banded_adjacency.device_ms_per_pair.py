"""models/pipeline: device ms a pair of `banded_adjacency` inside the
captured fit's replays, the banded adjacency and its neighbour list
(band_list) (portbench/stages.py)."""

from portbench import stages


def read(trace):
    return stages.device_ms_per_pair(trace, "banded_adjacency")
