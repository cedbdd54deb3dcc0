"""Device milliseconds of the intrinsics solver's CG per LM iteration: the
operations launched inside the program's ``ba_intr.cg`` spans (the CG
loop of each step, its bin sums included), over the traced slice's LM
iterations."""


def read(sl):
    iters = sl.total("iters")
    if not iters or not sl.ops or not sl.span_count("ba_intr.cg"):
        return None
    return 1e3 * sl.device_s(sl.under(["ba_intr.cg"])) / iters
