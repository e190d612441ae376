"""Host ms of loop detection (`PlaceRecognition.detect_loop`) a keyframe
resolved: the program's own `placerec_detect` timer."""


def read(t):
    spans = t["timings"].get("placerec_detect")
    if not spans or not t["resolved"]:
        return None
    return 1e3 * sum(spans) / t["resolved"]
