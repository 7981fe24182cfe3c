"""Host time of ``io.pack`` (``DeviceDataset.from_clouds`` packing the host clouds
into numpy arrays), a batch of the traced stretch."""

from portbench import program_spans


def read(s: dict):
    return program_spans.ms_per_unit(s, ("io.pack",), "host_ms")
