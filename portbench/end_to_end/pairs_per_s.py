"""Pairs whose results reached the host in the window, over the window's
seconds (its start to the end of its last call): all the work over all
the time, so a stall lowers it."""


def read(window):
    return window.pairs / window.elapsed_s
