"""What the tools share: host-clock timing (a chain of calls with one
synchronisation, best of a few windows), CUDA-graph timing, the card line
every printed number names, and the production model and batch the JAX
package's tools time."""

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


def best_synced_s(step: Callable[[], None], device: torch.device, steps: int,
                  repeats: int) -> float:
    """Seconds per call of ``step``, each call ended by a synchronisation (a
    chain of dispatches would hide a per-call cost): one warm-up call, then
    the best of ``repeats`` windows of ``steps`` calls."""
    step()
    sync(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
            sync(device)
        best = min(best, (time.perf_counter() - t0) / steps)
    return best


def card(device: torch.device) -> str:
    """What a printed number was measured on: the card's name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them, or the CPU."""
    if device.type != "cuda":
        import platform

        return f"cpu ({platform.machine()}, {torch.get_num_threads()} threads)"
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[min(device.index or 0, len(lines) - 1)] if lines else "nvidia-smi: no output"


def flagship(b: int, n: int, device: torch.device, seed: int = 0, **model_fields):
    """(trainer, batch): the production model (``core/config.py`` defaults,
    ``model_fields`` changed; torch's default init from ``seed``) in a
    ``Trainer`` on ``device``, and a batch of ``b`` clouds of ``n`` points
    drawn as the JAX package's tools draw theirs (positions N(0, 5), one
    N(0, 1) feature, every point valid, targets N(0, 1))."""
    import dataclasses

    import numpy as np

    from dl_biomass_tpu_torch.core.cloud import CloudBatch
    from dl_biomass_tpu_torch.core.config import HyperParams, TrainConfig
    from dl_biomass_tpu_torch.models.pointnet2 import build_model, seeded_init
    from dl_biomass_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(0)
    batch = CloudBatch(
        pos=torch.from_numpy((rng.normal(size=(b, n, 3)) * 5).astype(np.float32)),
        feat=torch.from_numpy(rng.normal(size=(b, n, 1)).astype(np.float32)),
        mask=torch.ones((b, n), dtype=torch.bool),
        y=torch.from_numpy(rng.normal(size=(b, 4)).astype(np.float32))).to(device)
    cfg = TrainConfig(hp=HyperParams(batch_size=b))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model_fields))
    return Trainer(seeded_init(seed, build_model, cfg, 1), cfg, device), batch


def graph_ms(fn: Callable[[], None], calls: int, replays: int) -> float:
    """Device ms a call of ``fn`` on the card: ``calls`` calls captured in one
    CUDA graph, the median of ``replays`` replays between two events, so that
    no host work stands between the launches."""
    import statistics

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    return statistics.median(times)
