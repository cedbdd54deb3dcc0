"""Reads of the device by the host per LM iteration: the program's spans
whose name ends in ``.host_read`` (each a copy or a scalar the host waits
for, where the device's queue drains), over the traced slice's LM
iterations."""


def read(sl):
    iters = sl.total("iters")
    reads = sum(1 for n, _, _ in sl.spans if n.endswith(".host_read"))
    if not iters or not sl.ops or not reads:
        return None
    return reads / iters
