"""Milliseconds of the traced slice per LM iteration of its solves."""


def read(sl):
    iters = sl.total("iters")
    return 1e3 * sl.window_s / iters if iters else None
