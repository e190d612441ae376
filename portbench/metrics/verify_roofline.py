"""The verification's share of its roofline: the least time the card
could take for the verification kernels' work (`harness/work.py`, from
their inputs, at the published peaks) over the device's busy time in the
segments of the trace that verification spans issued.  Nothing where the
trace could not be cut by span."""


def read(t):
    dev = t["device"]
    if dev is None or not t["least_verify_s"] or not dev["by_label_s"]:
        return None
    busy = dev["by_label_s"].get("verify")
    if not busy or busy <= 0:
        return None
    return 100.0 * t["least_verify_s"] / busy
