"""Host time of ``io.upload`` (the copies to the card in ``DeviceDataset``'s
constructor), a batch of the traced stretch."""

from portbench import program_spans


def read(s: dict):
    return program_spans.ms_per_unit(s, ("io.upload",), "host_ms")
