"""Kernels the device ran in the traced slice per LM iteration: the host's
dispatch of the LM loop."""


def read(sl):
    iters = sl.total("iters")
    return sl.kernels() / iters if iters else None
