"""Device time between the marks of ``train.forward`` (the model call of
``Trainer._step``), a step of the traced stretch."""

from portbench import program_spans


def read(s: dict):
    return program_spans.ms_per_unit(s, ("train.forward",), "device_ms")
