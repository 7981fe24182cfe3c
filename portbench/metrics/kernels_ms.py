"""Device time a step or batch in the port's own CUDA kernels (``ops/``)."""


def read(s: dict):
    t = s.get("trace")
    if not t or not s.get("trace_units") or not t["device_s"].get("port"):
        return None
    return 1e3 * t["device_s"]["port"] / s["trace_units"]
