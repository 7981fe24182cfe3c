"""Device time between the marks of ``train.assemble`` (``DeviceDataset.assemble``
in ``Trainer._device_epoch``: the batch gathered and augmented on the card), a
step of the traced stretch."""

from portbench import program_spans


def read(s: dict):
    return program_spans.ms_per_unit(s, ("train.assemble",), "device_ms")
