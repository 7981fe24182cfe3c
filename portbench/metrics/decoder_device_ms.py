"""Device time between the marks of the segmentor's decoder and head in its
forward (``model.fp3``, ``model.fp2``, ``model.fp1`` and ``model.seg_head``,
``models/decoder.PointNet2Segmentor``), a step of the traced stretch."""

from portbench import program_spans

SPANS = ("model.fp3", "model.fp2", "model.fp1", "model.seg_head")


def read(s: dict):
    parts = [program_spans.ms_per_unit(s, (name,), "device_ms") for name in SPANS]
    return None if None in parts else sum(parts)
