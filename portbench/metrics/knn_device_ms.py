"""Device time between the marks of ``fp.knn`` (``models/decoder.knn_interpolate``:
the dense distances, the mask, ``torch.topk`` and the weights of each FP
layer), a step of the traced stretch."""

from portbench import program_spans


def read(s: dict):
    return program_spans.ms_per_unit(s, ("fp.knn",), "device_ms")
