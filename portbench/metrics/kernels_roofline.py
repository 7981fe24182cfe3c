"""The port's selection and gather kernels' share of their roofline: the sum of
each launch's bound (``yardstick/work.py``, from the cell's shapes and data)
over the sum of their device time, for the kernel classes that ran."""


def read(s: dict):
    t = s.get("trace")
    bounds = s.get("bound_s_per_unit")
    if not t or not bounds or not s.get("trace_units"):
        return None
    ran = [c for c, sec in t["port_s"].items() if sec > 0 and c in bounds]
    spent = sum(t["port_s"][c] for c in ran)
    if not spent:
        return None
    return 100.0 * sum(bounds[c] for c in ran) * s["trace_units"] / spent
