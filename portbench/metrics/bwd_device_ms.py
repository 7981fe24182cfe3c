"""Device time between the marks of ``train.backward`` (the loss and its
``backward()`` in ``Trainer._step``), a step of the traced stretch."""

from portbench import program_spans


def read(s: dict):
    return program_spans.ms_per_unit(s, ("train.backward",), "device_ms")
