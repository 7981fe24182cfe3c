"""The host's share of a training step (port of the JAX package's
``tools/dispatch_probe.py`` and ``tools/multistep_probe.py``, which split a
step's wall between the TPU's execute round trips and its device time).

For the default production step and the ``fused_sa`` step at B x N:

- wall ms a step with G steps between synchronisations, G in {1, 2, 4, 8}
  (best of ``repeats``): a host that keeps ahead of the device shows the
  device's time at every G; a host that falls behind shows its own;
- device-busy ms a step: the kernels' time in a ``torch.profiler`` window of
  ``steps`` steps, summed;
- the host's ms to issue one step: ``Trainer.step`` returning, without a
  synchronisation, after the device has drained (median of ``steps``).

The trainer is not changed. Every line names the card and its power limit.

    python -m dl_biomass_tpu_torch.tools.dispatch_probe [B] [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.tools._timing import card, flagship, sync
from dl_biomass_tpu_torch.tools.profile_step import aggregate
from dl_biomass_tpu_torch.utils.profiling import trace

GROUPS = (1, 2, 4, 8)
STEPS = 8
REPEATS = 3


def probe(trainer, batch, device, groups=GROUPS, steps: int = STEPS,
          repeats: int = REPEATS) -> dict:
    """The three measures of one model's step."""
    import tempfile

    gen = torch.Generator(device=device).manual_seed(1)

    def step():
        trainer.step(batch, gen)

    step()
    sync(device)
    wall = {}
    for g in groups:
        best = float("inf")
        for _ in range(repeats):
            sync(device)
            t0 = time.perf_counter()
            for _ in range(g):
                step()
            sync(device)
            best = min(best, (time.perf_counter() - t0) / g)
        wall[g] = best * 1e3
    issue = []
    for _ in range(steps):
        sync(device)
        t0 = time.perf_counter()
        step()
        issue.append((time.perf_counter() - t0) * 1e3)
    sync(device)
    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir) as prof:
            for _ in range(steps):
                step()
            sync(device)
    busy, _, _ = aggregate(prof, steps, device.type == "cuda")
    return dict(wall_ms_by_group=wall, busy_ms=busy, issue_ms=statistics.median(issue))


def main(b: int = 16, n: int = 10240, device=None, groups=GROUPS, steps: int = STEPS,
         repeats: int = REPEATS) -> list:
    """Probe the default and the ``fused_sa`` step; prints a line each and
    returns them as dicts."""
    dev = resolve_device(device)
    where = card(dev)
    rows = []
    for fused_sa in (False, True):
        trainer, batch = flagship(b, n, dev, fused_sa=fused_sa)
        res = probe(trainer, batch, dev, groups, steps, repeats)
        name = "fused_sa" if fused_sa else "default"
        row = dict(step=name, b=b, n=n, card=where, **res)
        rows.append(row)
        walls = ", ".join(f"G={g} {ms:.3f}" for g, ms in res["wall_ms_by_group"].items())
        what = "device" if dev.type == "cuda" else "CPU (the operators' own time)"
        print(f"dispatch_probe {name} step B={b} x {n}: wall ms a step with G steps a "
              f"synchronisation {walls}; busy {res['busy_ms']:.3f} ms a step on the {what}; "
              f"the host issues a step in {res['issue_ms']:.3f} ms (median of {steps}, the "
              f"device drained first) [{where}]", flush=True)
        del trainer, batch
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="dispatch_probe")
    p.add_argument("b", nargs="?", type=int, default=16)
    p.add_argument("n", nargs="?", type=int, default=10240)
    p.add_argument("--device", default=None, help="cpu: the kernels' plain versions")
    a = p.parse_args()
    main(a.b, a.n, a.device)
