"""Share of the traced window in which the device ran nothing: 100 less
the union of its kernel, copy and set intervals (torch.profiler) over the
window's host length."""


def read(t):
    dev = t["device"]
    if dev is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / t["window_s"])
