"""Rerun one row of the seed study with the augmentation's pre-fix seeding
(port of the JAX package's ``tools/fps_divergence_probe.py``).

The JAX package's seed study once had a production row (exact FPS, seed 1)
that never descended. That run predates the domain tag that keeps each
batch's augmentation key (``fold_in(key, b0)``) off the trainer's step key
(``fold_in(key, i)``): at batch 0 the two were one key, so the first step's
augmentation draws were its dropout and FPS draws, every epoch. The port
seeds each batch's augmentation generator with (seed, ``AUG_KEY_DOMAIN``,
b0) and the steps' generator with the seed (``io/device_data.py``).
``--old-keys`` rebuilds the collision inside this tool, without a switch in
the package: ``DeviceDataset.aug_seed`` is patched to the seed plus b0, so
batch 0's augmentation generator is seeded as the step generator is and
draws its stream.

    python -m dl_biomass_tpu_torch.tools.fps_divergence_probe --seed 1
    python -m dl_biomass_tpu_torch.tools.fps_divergence_probe --seed 1 --old-keys

Prints the row (val MSE, epochs, R^2, clouds/s) as a JSON line with the card
and its power limit; ``--out`` appends it to a JSON list.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from unittest import mock

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.io.device_data import DeviceDataset
from dl_biomass_tpu_torch.tools._timing import card


@contextlib.contextmanager
def old_keys():
    """Each batch's augmentation seed without the domain tag: the epoch's
    seed plus the batch's offset, so that batch 0's is the step generator's
    seed."""
    def aug_seed(self, seed, b0):
        return (0 if seed is None else int(seed)) + int(b0)

    with mock.patch.object(DeviceDataset, "aug_seed", aug_seed):
        yield


def main(seed: int = 1, mode: str = "production", old: bool = False, out=None, device=None,
         **study) -> dict:
    """The seed study's row for ``seed`` and ``mode`` (``study``: more of
    ``run_seed_study``'s arguments), with the pre-fix seeding where
    ``old``; prints it and returns it."""
    from dl_biomass_tpu_torch.experiments.seed_study import run_seed_study

    dev = resolve_device(device)
    with old_keys() if old else contextlib.nullcontext():
        res = run_seed_study([seed], [mode], device=dev, log_fn=lambda _: None, **study)
    row = dict(res["runs"][0], old_keys=old, card=card(dev))
    print(json.dumps(row), flush=True)
    if out:
        rows = []
        if os.path.exists(out):
            with open(out) as f:
                rows = json.load(f)
        rows.append(row)
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
    return row


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="fps_divergence_probe")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--mode", default="production", help="seed-study mode (production: exact FPS)")
    p.add_argument("--old-keys", action="store_true",
                   help="seed batch 0's augmentation as the steps' generator (pre-fix)")
    p.add_argument("--out", default=None, help="append the row to this JSON list")
    p.add_argument("--device", default=None, help="cpu: the kernels' plain versions")
    a = p.parse_args()
    main(a.seed, a.mode, a.old_keys, a.out, a.device)
