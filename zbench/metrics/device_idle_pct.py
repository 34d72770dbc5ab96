"""Share of the traced window in which no operation ran on the device."""


def read(w):
    if w.trace is None or not w.trace["window_s"]:
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.trace["window_s"])
