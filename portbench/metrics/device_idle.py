"""The share of the traced stretch in which no operation ran on the card."""


def read(s: dict):
    t = s.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
