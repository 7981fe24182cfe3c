"""Device time a step in communication kernels (NCCL): ``parallel/mesh``'s sums."""


def read(s: dict):
    t = s.get("trace")
    if not t or not s.get("trace_units") or not t["device_s"].get("comm"):
        return None
    return 1e3 * t["device_s"]["comm"] / s["trace_units"]
