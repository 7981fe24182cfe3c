"""Device time between the marks of SA2: ``model.sa2`` in the model's forward
(training), else ``engine.sa2`` in the serving engine; a step or batch of the
traced stretch."""

from portbench import program_spans


def read(s: dict):
    return program_spans.ms_per_unit(s, ("model.sa2", "engine.sa2"), "device_ms")
