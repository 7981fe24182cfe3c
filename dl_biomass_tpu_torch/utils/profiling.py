"""Tracing and timing of the port (port of ``dl_biomass_tpu/utils/profiling.py``).

The reference's only performance instrumentation is wall-clock timing around
whole training runs (``point_density_effect.py:155-163``). Here:

- ``span(name, device=None)`` marks a stage of a training step or of a served
  request, and ``count(name, value)`` adds up a number of work done there
  (the valid neighbour slots, say). Both record only while a
  ``torch.profiler`` session is active (torch's own fast flag,
  ``torch.autograd.profiler._is_profiler_enabled``) or inside
  ``recording()``, and never while ``torch.compiler.is_compiling()``, so
  ``torch.export`` traces none of it. Off, ``span`` is one check of that
  flag and returns a shared no-op context: no allocation, no CUDA call, no
  lock.
- A span keeps ``(start_ns, end_ns, name, parent, seq)`` in memory:
  ``time.time_ns()``, the wall clock the profiler's own events carry;
  ``parent`` the enclosing span on the same thread; ``seq`` the number of
  the outermost span, shared by everything inside it (a step's spans, a
  batch's). With device marks, a CUDA event with timing is recorded on the
  current stream at entry and at exit; events come from a pool and are read
  as milliseconds only by ``collect()``, so recording never waits for the
  card.
- ``collect()`` resolves and returns the spans and counters, ``spans_items()``
  the ``(start_ns, end_ns, name)`` tuples, ``clear()`` empties both. A span
  that starts while ``MAX_SPANS`` are kept is not recorded, only counted as
  dropped.
- ``trace(logdir)``: a ``torch.profiler`` window over the CPU and the card,
  written to ``logdir/trace.json`` (Chrome trace, for Perfetto or
  ``chrome://tracing``) with the window's spans in a lane of their own.

Work on the card is queued asynchronously: a wall-clock time means something
only after ``hard_sync``, which waits for the card the tensor lies on.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 16
_FOLD = 64  # device counter values kept before they are summed on the device
SPANS_LANE = "dl_biomass_tpu_torch spans"


class Span(NamedTuple):
    """A resolved span: host times on the wall clock in ns, the device time
    between its marks in ms (None without marks)."""
    start_ns: int
    end_ns: int
    name: str
    parent: Optional[str]
    seq: int
    thread: int
    device_ms: Optional[float]

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Recorder:
    """The spans and counters recorded so far, and the pool of CUDA events
    their device marks use."""

    def __init__(self):
        # [start, end, name, parent, seq, thread, ev0, ev1, device index, device ms]
        self.records: List[list] = []
        self.counters: Dict[str, list] = {}  # name -> [host total, {device: [0-d tensors]}]
        self.dropped = 0
        self.forced = 0
        self.seq = itertools.count(1)
        self.local = threading.local()
        self.free: Dict[int, list] = defaultdict(list)  # device index -> idle events

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def event(self, index: int) -> "torch.cuda.Event":
        free = self.free[index]
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def release(self, index: int, *events) -> None:
        self.free[index].extend(e for e in events if e is not None)


_REC = Recorder()
_NOOP = contextlib.nullcontext()


def enabled() -> bool:
    """Whether spans and counters are recorded now: for a call site that must
    compute a counter's value only when it is kept."""
    return bool(_REC.forced or _autograd_profiler._is_profiler_enabled) \
        and not torch.compiler.is_compiling()


def _stream_of(device) -> Optional["torch.cuda.Stream"]:
    """The current stream of ``device`` (a tensor's device, or a device) where
    it is a card."""
    if device is None:
        return None
    dev = device.device if torch.is_tensor(device) else torch.device(device)
    return torch.cuda.current_stream(dev) if dev.type == "cuda" else None


class _Span:
    __slots__ = ("name", "stream", "start", "ev0", "parent", "seq")

    def __init__(self, name: str, stream):
        self.name, self.stream = name, stream

    def __enter__(self):
        stack = _REC.stack()
        if stack:
            self.parent, self.seq = stack[-1].name, stack[-1].seq
        else:
            self.parent, self.seq = None, next(_REC.seq)
        stack.append(self)
        self.start = time.time_ns()
        self.ev0 = None
        if self.stream is not None:
            self.ev0 = _REC.event(self.stream.device_index)
            self.ev0.record(self.stream)
        return self

    def __exit__(self, *exc):
        ev1 = None
        if self.ev0 is not None:
            ev1 = _REC.event(self.stream.device_index)
            ev1.record(self.stream)
        end = time.time_ns()
        _REC.stack().pop()
        index = self.stream.device_index if self.stream is not None else -1
        _REC.records.append([self.start, end, self.name, self.parent, self.seq,
                             threading.get_ident(), self.ev0, ev1, index, None])
        return False


def span(name: str, device=None):
    """A context that records the enclosed stage as ``name`` while recording
    is on, with device marks where ``device`` (a tensor, whose device counts,
    or a device) is a card; otherwise the shared no-op context."""
    if not (_REC.forced or _autograd_profiler._is_profiler_enabled):
        return _NOOP
    if torch.compiler.is_compiling():
        return _NOOP
    if len(_REC.records) >= MAX_SPANS:
        _REC.dropped += 1
        return _NOOP
    return _Span(name, _stream_of(device))


def count(name: str, value) -> None:
    """Add ``value`` (a host number, or a 0-d tensor summed where it lies and
    read by ``collect``) to the counter ``name`` while recording is on."""
    if not enabled():
        return
    c = _REC.counters.setdefault(name, [0, defaultdict(list)])
    if not torch.is_tensor(value):
        c[0] += value
        return
    pending = c[1][value.device]
    pending.append(value.detach().reshape(()))
    if len(pending) >= _FOLD:
        pending[:] = [torch.stack(pending).sum()]


def _resolve() -> None:
    for r in _REC.records:
        ev0, ev1 = r[6], r[7]
        if ev0 is not None:
            ev1.synchronize()
            r[6], r[7], r[9] = None, None, ev0.elapsed_time(ev1)
            _REC.release(r[8], ev0, ev1)
    for c in _REC.counters.values():
        for pending in c[1].values():
            if pending:
                c[0] += torch.stack(pending).sum().item()
                pending.clear()


def collect() -> dict:
    """``{"spans": [Span, ...], "counters": {name: number}, "dropped": n}``:
    everything recorded since ``clear()``, device marks resolved (this waits
    for them); nothing is cleared."""
    _resolve()
    spans = [Span(*r[:6], r[9]) for r in _REC.records]
    return {"spans": spans, "counters": {k: c[0] for k, c in _REC.counters.items()},
            "dropped": _REC.dropped}


def spans_items() -> List[Tuple[int, int, str]]:
    """The spans as ``(start_ns, end_ns, name)``, the shape of the benchmark's
    own ranges (``portbench.trace.Spans.items``)."""
    return [(r[0], r[1], r[2]) for r in _REC.records]


def clear() -> None:
    """Forget every span and counter; their events go back to the pool."""
    for r in _REC.records:
        if r[6] is not None:
            _REC.release(r[8], r[6], r[7])
    _REC.records.clear()
    _REC.counters.clear()
    _REC.dropped = 0


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, profiler or not."""
    _REC.forced += 1
    try:
        yield
    finally:
        _REC.forced -= 1


def _first_tensor(x) -> Optional[torch.Tensor]:
    if torch.is_tensor(x):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def hard_sync(x) -> None:
    """Wait until the card that holds ``x`` (a tensor, or the first tensor of
    a dict, list or tuple) has finished all queued work; a no-op for a CPU
    tensor, which is computed when it is returned."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _write_spans(path: str, spans: List[Span]) -> None:
    """Add ``spans`` to the Chrome trace at ``path`` as complete events in a
    process lane of their own, on the trace's timebase (its
    ``baseTimeNanoseconds``), a thread lane per recording thread."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = max([e["pid"] for e in events if isinstance(e.get("pid"), int)] + [0]) + 1
    lanes: Dict[int, int] = {}
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": SPANS_LANE}})
    for s in spans:
        args = {"seq": s.seq, "parent": s.parent}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                       "tid": lanes.setdefault(s.thread, len(lanes)),
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Record CPU and CUDA activity of the enclosed block with
    ``torch.profiler``; writes ``logdir/trace.json`` (Chrome trace) with the
    block's spans beside the device lanes."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _write_spans(path, [s for s in collect()["spans"] if s.start_ns >= t0])
