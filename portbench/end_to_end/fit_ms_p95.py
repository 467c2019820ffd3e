"""95th percentile, over every pair completed in the window, of the time
from handing the pair's host arrays to the entry until its results are
on the host (one caller, one pair in flight). None for a cell whose
calls hold several pairs."""

import numpy as np


def read(window):
    if window.pairs_per_call != 1:
        return None
    return float(np.percentile(window.call_ms, 95))
