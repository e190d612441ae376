"""Host ms of one loop correction or merge (`MapManager.handle_loop`): the
harness's span, a mean over the calls."""


def read(t):
    spans = t["spans"].get("correct")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
