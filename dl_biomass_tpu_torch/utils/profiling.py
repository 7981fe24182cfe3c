"""Profiling / step-timing utilities (port of ``dl_biomass_tpu/utils/profiling.py``).

The reference's only performance instrumentation is wall-clock timing around
whole training runs (``point_density_effect.py:155-163``). Here a
``torch.profiler`` trace (Chrome trace format, viewable in Perfetto or
``chrome://tracing``) and a per-step timer that feeds the clouds/sec metric.

Work on the card is queued asynchronously: a wall-clock time means something
only after ``hard_sync``, which waits for the card the tensor lies on.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


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


@contextlib.contextmanager
def trace(logdir: str):
    """Record CPU and CUDA activity of the enclosed block with
    ``torch.profiler``; writes ``logdir/trace.json`` (Chrome trace)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Accumulates per-step wall times and derives throughput."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        if sync_on is not None:
            hard_sync(sync_on)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self, items_per_step: int = 1) -> Dict[str, float]:
        t = np.asarray(self.times[1:] or self.times)  # drop the first (warm-up) step
        return {
            "steps": len(self.times),
            "mean_ms": float(t.mean() * 1000),
            "p50_ms": float(np.percentile(t, 50) * 1000),
            "p95_ms": float(np.percentile(t, 95) * 1000),
            "items_per_sec": float(items_per_step / t.mean()),
        }
