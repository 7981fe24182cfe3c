"""Device time a step or batch in cuBLAS GEMM kernels (``models/layers.dot_f32``)."""


def read(s: dict):
    t = s.get("trace")
    if not t or not s.get("trace_units") or not t["device_s"].get("gemm"):
        return None
    return 1e3 * t["device_s"]["gemm"] / s["trace_units"]
