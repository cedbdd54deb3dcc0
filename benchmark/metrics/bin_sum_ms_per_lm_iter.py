"""Device milliseconds of the camera bin sums per LM iteration: the
operations launched inside the program's ``ba.bins`` spans (the gather
into bin order and the segment sum), over the traced slice's LM
iterations."""


def read(sl):
    iters = sl.total("iters")
    if not iters or not sl.ops or not sl.span_count("ba.bins"):
        return None
    return 1e3 * sl.device_s(sl.under(["ba.bins"])) / iters
