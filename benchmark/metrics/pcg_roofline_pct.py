"""The PCG's share of its roofline: the frozen bound of one solve of the
reduced camera system (``roofline.bounds.pcg_bound``), times the calls in
the traced slice (spans ``ba_soa.pcg``), over the device time of the
kernels launched inside those spans."""

from benchmark.roofline import bounds


def read(sl):
    calls = sl.span_count("ba_soa.pcg")
    dev_s = sl.device_s(sl.under(["ba_soa.pcg"]))
    if not calls or dev_s <= 0:
        return None
    i = sl.info
    ms, _ = bounds.pcg_bound(i["C"], i["cg_iterations"], i["itemsize"])
    return 100.0 * calls * ms / 1e3 / dev_s
