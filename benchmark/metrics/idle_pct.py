"""Share of the traced slice in which no operation ran on the device."""


def read(sl):
    if sl.window_s <= 0 or not sl.ops:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
