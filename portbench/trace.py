"""The traced stretch of a run: ``torch.profiler`` over a few steps or requests,
reduced to what the per-layer metrics read.

The profiler traces the device and the CUDA runtime calls; the benchmark's
own host ranges (``Spans``) are kept on the same wall clock. The reduction
keeps, for the ``portbench.stretch`` range: the device intervals (kernels,
copies, sets), their union (``busy_s``), the device time by class of
``yardstick/kernel_classes.json``, the host's time inside synchronising
runtime calls and copies to host memory (``wait_s``), the device operations that took most time, and
the longest idle gaps of the device, each named by what the host was doing
at the gap's middle: the innermost benchmark range and the runtime call.
"""

from __future__ import annotations

import contextlib
import json
import re
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

CLASSES = json.loads(Path(__file__).with_name("yardstick").joinpath(
    "kernel_classes.json").read_text())
_PATTERNS = [(("port", sub), [re.compile(p) for p in pats])
             for sub, pats in CLASSES["port"].items()]
_PATTERNS += [((cls, None), [re.compile(p) for p in CLASSES[cls]])
              for cls in ("gemm", "comm", "copy")]
TOP = 10


def classify(name: str) -> Tuple[str, str]:
    """(class, port kernel or None) of a device operation by its name."""
    for key, pats in _PATTERNS:
        if any(p.search(name) for p in pats):
            return key
    return ("torch", None)


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


class Spans:
    """The benchmark's own host ranges, on the wall clock the profiler's
    timestamps use; recorded only while a stretch is profiled."""

    def __init__(self):
        self.items: List[Tuple[int, int, str]] = []
        self.on = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((t0, time.time_ns(), name))


def profile(fn: Callable[[], None], spans: Spans) -> dict:
    """Run ``fn`` under the profiler, tracing the device and the CUDA runtime
    calls only (recording every host operator would slow the host by a
    seventh, see PERF.md), and reduce the trace (see the module)."""
    from torch.profiler import ProfilerActivity, profile as _profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    sync()
    spans.items, spans.on = [], True
    with _profile(activities=acts) as prof:
        with spans("portbench.stretch"):
            fn()
            sync()
    spans.on = False
    t_reduce = time.perf_counter()
    out = reduce(prof.profiler.kineto_results.events(), spans.items)
    out["reduce_s"] = time.perf_counter() - t_reduce
    return out


def reduce(events, spans) -> dict:
    """The stretch of ``spans`` named ``portbench.stretch``, reduced."""
    lo, hi = next((a, b) for a, b, n in spans if n == "portbench.stretch")
    dev, calls, to_host = [], [], set()
    for ev in events:
        start, dur = ev.start_ns(), ev.duration_ns()
        if _is_device(ev):
            dev.append((max(start, lo), min(start + dur, hi), ev.name()))
            if "DtoH" in ev.name():
                to_host.add(ev.correlation_id())
        else:
            calls.append((start, start + dur, ev.name(), ev.correlation_id()))
    dev = sorted(d for d in dev if d[1] > d[0])
    by_class: Dict[str, float] = defaultdict(float)
    by_port: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    names: Dict[str, set] = defaultdict(set)
    merged: List[List[int]] = []
    for a, b, name in dev:
        cls, port = classify(name)
        by_class[cls] += (b - a) * 1e-9
        if port:
            by_port[port] += (b - a) * 1e-9
        by_name[name] += (b - a) * 1e-9
        names[port or cls].add(name[:80])
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-9
    gaps = []
    edge = lo
    for a, b in merged:
        if a > edge:
            gaps.append((a - edge, (a + edge) // 2))
        edge = max(edge, b)
    if hi > edge:
        gaps.append((hi - edge, (hi + edge) // 2))
    gaps = sorted(gaps, reverse=True)[:TOP]
    # the host waits for the card in a synchronisation, or in a copy to host
    # memory, which returns once the queued work and the copy are done
    waits = sum(min(b, hi) - max(a, lo) for a, b, n, c in calls
                if ("Synchronize" in n or c in to_host) and b > lo and a < hi) * 1e-9
    calls = [(a, b, n) for a, b, n, _ in calls]
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": busy,
        "wait_s": waits,
        "device_s": dict(by_class),
        "port_s": dict(by_port),
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": [[_host_at(spans, calls, at), g * 1e-9] for g, at in gaps],
        "names": {c: sorted(v)[:8] for c, v in names.items()},
    }


def _innermost(ranges, t: int):
    inside = [(a, n) for a, b, n in ranges if a <= t < b]
    return max(inside)[1] if inside else None


def _host_at(spans, calls, t: int) -> str:
    """What the host was doing at ``t``: the innermost benchmark range, and the
    CUDA runtime call it was in, if any."""
    span = _innermost([x for x in spans if x[2] != "portbench.stretch"], t) or "portbench.stretch"
    return f"{span} > {_innermost(calls, t) or 'host code (no runtime call)'}"
