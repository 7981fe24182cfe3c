"""Host time of the port's ``train.step`` span (the whole of ``Trainer._step``:
issue, and any wait inside it), a step of the traced stretch."""

from portbench import program_spans


def read(s: dict):
    return program_spans.ms_per_unit(s, ("train.step",), "host_ms")
