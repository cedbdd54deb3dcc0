"""Device milliseconds per frame of the front end's SIFT and line lift:
operations launched inside the program's ``sift.*`` and
``extraction.lift`` spans, over the traced slice's frames."""


def read(sl):
    frames = sl.total("frames")
    dev_s = sl.device_s(sl.under(["sift.", "extraction.lift"]))
    return 1e3 * dev_s / frames if frames and dev_s > 0 else None
