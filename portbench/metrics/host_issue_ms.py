"""Host time a step or batch outside the host's waits for the card: the traced
stretch less its synchronising runtime calls and copies to host memory, over
the steps or batches."""


def read(s: dict):
    t = s.get("trace")
    if not t or not s.get("trace_units"):
        return None
    return 1e3 * (t["window_s"] - t["wait_s"]) / s["trace_units"]
