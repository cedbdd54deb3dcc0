"""The top-2 match kernel's share of its roofline: the frozen bound of each
call over the pairs' valid descriptors (``roofline.bounds.
match_bound_pairs``), summed over the traced slice's calls, over the
device time of the ``match_top2`` kernels."""

from benchmark.roofline import bounds


def read(sl):
    calls = [c for u in sl.units for c in u.get("match_calls", [])]
    dev_s = sl.device_s(sl.named("match_top2"))
    if not calls or dev_s <= 0:
        return None
    ms = sum(bounds.match_bound_pairs(c)[0] for c in calls)
    return 100.0 * ms / 1e3 / dev_s
