"""Device time between the marks of SA1: ``model.sa1`` in the model's forward
(training), else ``engine.sa1`` in the serving engine; a step or batch of the
traced stretch."""

from portbench import program_spans


def read(s: dict):
    return program_spans.ms_per_unit(s, ("model.sa1", "engine.sa1"), "device_ms")
