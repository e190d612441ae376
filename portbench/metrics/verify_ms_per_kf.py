"""Host ms of verification a keyframe resolved: the harness's spans around
`PlaceRecognition.dispatch_verify` and `finalize_verify`, summed."""


def read(t):
    spans = t["spans"].get("verify")
    if not spans or not t["resolved"]:
        return None
    return 1e3 * sum(spans) / t["resolved"]
