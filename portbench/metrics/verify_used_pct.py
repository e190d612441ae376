"""Share of the dispatched verifications whose result was fetched:
`finalize_verify` calls over the program's `PlaceRecognition.n_dispatched`."""


def read(t):
    if not t["dispatched"]:
        return None
    return 100.0 * t["counts"].get("finalize", 0) / t["dispatched"]
