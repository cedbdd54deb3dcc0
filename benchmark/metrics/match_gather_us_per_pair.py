"""Device microseconds of the matcher's gathers per pair: the operations
launched inside the program's ``matching.gather`` spans (each pair's
descriptor and valid rows taken from the tables), over the traced slice's
pairs.  Reads every part, ``.frontend`` and ``.match``."""


def read(sl):
    pairs = sl.total("pairs")
    if not pairs or not sl.ops or not sl.span_count("matching.gather"):
        return None
    return 1e6 * sl.device_s(sl.under(["matching.gather"])) / pairs
