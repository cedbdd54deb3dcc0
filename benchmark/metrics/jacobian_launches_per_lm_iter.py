"""Kernels launched inside the program's ``ba.jacobians`` spans (the
residual and Jacobian pass of ``vmap(jacfwd)``) per LM iteration of the
traced slice."""


def read(sl):
    iters = sl.total("iters")
    if not iters or not sl.ops or not sl.span_count("ba.jacobians"):
        return None
    under = sl.under(["ba.jacobians"])
    return sum(1 for o in sl.ops if o.cat == "kernel" and under(o)) / iters
