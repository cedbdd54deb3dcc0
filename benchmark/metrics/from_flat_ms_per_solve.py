"""Host milliseconds of the BA problem layout per solve: the program's
``ba_dense.from_flat_problem`` spans (the flat problem regrouped into
per-point slots on the host, with its reads of the device), their summed
duration over their count."""


def read(sl):
    spans = [e - s for n, s, e in sl.spans
             if n == "ba_dense.from_flat_problem"]
    if not spans or not sl.ops:
        return None
    return sum(spans) / 1e3 / len(spans)
