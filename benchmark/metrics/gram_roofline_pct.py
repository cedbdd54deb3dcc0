"""The Schur Gram's share of its roofline: the frozen bound of one call at
the problem's shapes (``roofline.bounds.gram_bound``), times the calls in
the traced slice (spans ``ba_soa.gram``), over the device time of the
kernels launched inside those spans."""

from benchmark.roofline import bounds


def read(sl):
    calls = sl.span_count("ba_soa.gram")
    dev_s = sl.device_s(sl.under(["ba_soa.gram"]))
    if not calls or dev_s <= 0:
        return None
    i = sl.info
    ms, _ = bounds.gram_bound(i["K"], i["P"], i["C"], i["track_lengths"],
                              i["itemsize"])
    return 100.0 * calls * ms / 1e3 / dev_s
