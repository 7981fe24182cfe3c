"""``torch.cuda.max_memory_allocated()`` over the measured window, in GiB."""


def read(s: dict):
    b = s.get("window_peak_bytes")
    return None if not b else b / 2**30
