"""Host-clock timing shared by the tools: a chain of calls with one
synchronisation, best of a few windows."""

from __future__ import annotations

import time
from typing import Callable

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_chain_s(step: Callable[[], None], device: torch.device, chain: int,
                 windows: int) -> float:
    """Seconds per call of ``step``: one warm-up chain, then the best of
    ``windows`` chains of ``chain`` calls, each ended by one synchronisation."""
    for _ in range(chain):
        step()
    sync(device)
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(chain):
            step()
        sync(device)
        best = min(best, (time.perf_counter() - t0) / chain)
    return best
