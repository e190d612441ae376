"""Ms of one pose-graph solve (`ops/pgo.optimize_pose_graph`): the
harness's span, the device synchronised at both ends, a mean over the
solves."""


def read(t):
    spans = t["spans"].get("pgo")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
