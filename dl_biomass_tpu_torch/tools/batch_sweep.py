"""Training and eval throughput of the production model by batch size at
10240 points a cloud (port of the JAX package's ``tools/batch_sweep.py``).

For each B (default 16, 32, 36, 48, 64): one warm-up step, then the best of
``repeats`` windows of ``steps`` training steps, each step ended by a
synchronisation (a chain of dispatches would hide the per-step cost); the
same for the module's eval forward. Prints a row a batch and a JSON line of
them, with the card and its power limit.

    python -m dl_biomass_tpu_torch.tools.batch_sweep [B ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.tools._timing import best_synced_s, card, flagship

N = 10240
BATCHES = (16, 32, 36, 48, 64)
TIMED_STEPS = 8
REPEATS = 3


def main(batches=BATCHES, n: int = N, device=None, steps: int = TIMED_STEPS,
         repeats: int = REPEATS) -> dict:
    """The sweep; prints a line a batch and the JSON line, returns its dict."""
    dev = resolve_device(device)
    where = card(dev)
    rows = {}
    for b in batches:
        trainer, batch = flagship(b, n, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        train = best_synced_s(lambda: trainer.step(batch, gen), dev, steps, repeats)
        infer = best_synced_s(lambda: trainer._eval_batch(batch), dev, steps, repeats)
        rows[str(b)] = {"clouds_per_sec": b / train, "ms_per_step": train * 1e3,
                        "ms_per_16_clouds": train * 1e3 * 16 / b,
                        "infer_clouds_per_sec": b / infer, "infer_ms_per_step": infer * 1e3}
        print(f"batch_sweep B={b} x {n}: {rows[str(b)]} [{where}]", flush=True)
        del trainer, batch
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out = {"metric": f"train_batch_sweep_{n}_pts", "rows": rows, "device": where}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="batch_sweep")
    p.add_argument("batches", nargs="*", type=int, default=list(BATCHES))
    p.add_argument("--points", type=int, default=N)
    p.add_argument("--device", default=None, help="cpu: the kernels' plain versions")
    a = p.parse_args()
    main(a.batches, a.points, a.device)
