"""The share of neighbour slots that hold a neighbour: 100 x ``edges.valid`` /
``edges.slots``, counted at every scale of SA1 and SA2 over the traced stretch
(pad clouds' slots included, all empty)."""

from portbench import program_spans


def read(s: dict):
    return program_spans.percent(s, "edges.valid", "edges.slots")
