"""The 90th percentile of the latency of every keyframe resolved in the
window: from the start of the `ingest_many` that delivered it to the
return of the `drain_placerec` that resolved it, the wait behind the
other agents' units included (host clock)."""

import numpy as np


def read(t):
    lat = t["latencies_s"]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), 90))
