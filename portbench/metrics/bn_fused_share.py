"""The share of the values that train-mode BatchNorms normalize which run on
kernel 11: 100 x ``bn.fused`` / ``bn.values``, counted at every train-mode
``MaskedBatchNorm`` over the traced stretch (SA3's and the head's run the
PyTorch chain)."""

from portbench import program_spans


def read(s: dict):
    return program_spans.percent(s, "bn.fused", "bn.values")
