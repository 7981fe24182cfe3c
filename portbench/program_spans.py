"""The port's own spans and counters over the traced stretch, as the
per-layer metrics of source ``program_span`` and ``program_counter`` read
them.

The traced stretch runs under ``torch.profiler``, and while a profiler
session is active the port records its spans and counters
(``dl_biomass_tpu_torch.utils.profiling``: a stage's host time on the wall
clock, and the device time between its marks); ``collect()`` hands them over
after the stretch. A program that records none gives nothing here, and the
metric is left out of the result line.
"""

from __future__ import annotations

from typing import Optional, Sequence


def recorded(s: dict) -> Optional[dict]:
    """The program's spans and counters of the traced stretch of summary
    ``s``, or None without a trace, its units, or a record."""
    if not s.get("trace") or not s.get("trace_units"):
        return None
    try:
        from dl_biomass_tpu_torch.utils import profiling

        collect = profiling.collect
    except (ImportError, AttributeError):
        return None
    rec = collect()
    return rec if rec["spans"] or rec["counters"] else None


def ms_per_unit(s: dict, names: Sequence[str], field: str) -> Optional[float]:
    """The ``field`` (``host_ms`` or ``device_ms``) of the spans named by the
    first of ``names`` that has any, summed over the stretch and divided by
    its steps or batches; None where there are none, or no device marks."""
    rec = recorded(s)
    if rec is None:
        return None
    for name in names:
        got = [getattr(x, field) for x in rec["spans"] if x.name == name]
        if got:
            return None if None in got else sum(got) / s["trace_units"]
    return None


def percent(s: dict, part: str, whole: str) -> Optional[float]:
    """100 x counter ``part`` / counter ``whole`` over the stretch."""
    rec = recorded(s)
    if rec is None:
        return None
    c = rec["counters"]
    return 100.0 * c[part] / c[whole] if c.get(whole) and part in c else None
