"""Host ms of `AgentSession.ingest_many` a keyframe delivered: the
harness's span around each call, the device synchronised at its end."""


def read(t):
    spans = t["spans"].get("ingest")
    if not spans or not t["units"]:
        return None
    return 1e3 * sum(spans) / t["units"]
