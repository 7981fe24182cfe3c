"""Device time a step or batch in the network's own PyTorch operations: kernels
that are neither cuBLAS GEMMs, nor the port's own, nor copies or collectives."""


def read(s: dict):
    t = s.get("trace")
    if not t or not s.get("trace_units"):
        return None
    return 1e3 * t["device_s"].get("torch", 0.0) / s["trace_units"]
