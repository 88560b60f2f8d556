"""The device's idle share of the traced part of the window, in %: 1 less
the union of every device operation's interval (kernels, copies, fills)
between the traced part's spans."""


def read(rec):
    t = rec["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
