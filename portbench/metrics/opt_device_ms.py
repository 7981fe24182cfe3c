"""Device time between the marks of ``train.optimizer`` (the gradient sum over a
mesh and ``optimizer.step()`` in ``Trainer._step``), a step of the traced
stretch."""

from portbench import program_spans


def read(s: dict):
    return program_spans.ms_per_unit(s, ("train.optimizer",), "device_ms")
