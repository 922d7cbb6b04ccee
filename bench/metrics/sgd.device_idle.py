"""Device idle share of the traced window (%): 1 - the union of the
device's kernel, copy and fill intervals over the window's host time."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
