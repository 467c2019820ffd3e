"""Process start to the first timed pair: imports, the card's start, the
kernel library's load (or build), the scenes, the warm-up call (for a
captured cell, the capture). Less the wait for the card's fast state
(portbench/launch_state.py), which the run reports beside it."""


def read(window):
    return window.setup_s
