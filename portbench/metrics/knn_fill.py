"""The share of the dense kNN selection's distances that pair a valid target
with a valid source: 100 x ``knn.pairs`` / ``knn.slots``, counted at every
FP layer's ``knn_interpolate`` over the traced stretch."""

from portbench import program_spans


def read(s: dict):
    return program_spans.percent(s, "knn.pairs", "knn.slots")
