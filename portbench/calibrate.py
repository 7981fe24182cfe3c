"""Readings the limits of ``limits/<workload>.json`` are set from, on the card.

    python -m portbench.calibrate --workload <name> --first-seed <n> [--seeds 12]
        [--variants 3] [--seconds 3]

For each of ``--seeds`` seeds the cell's set-up and a short window at the
cell's own load (a served check compares the window's requests; a training
check, set-up's first steps), then the check of the program; for
the first ``--variants`` of them also the control (the reference in fp8 in
the program's place) and every fault the traffic kind plants. A cell over
several ranks gets the control and the faults only (they need no program):
its program readings are those of its runs. One JSON line
per reading, then the largest program reading and the smallest control
and fault readings of each number. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from types import SimpleNamespace

from portbench import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--variants", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args(argv)
    run.fixed_environment()
    spec = run.resolve(run.load_manifest(), a.workload)

    import importlib

    import torch

    kind = importlib.import_module(f"portbench.kinds.{spec.traffic['kind']}")
    readings = {}
    for i in range(a.seeds):
        seed = a.first_seed + i
        world = int(spec.traffic.get("ranks", 1))
        ctx = SimpleNamespace(seed=seed, config=spec.config, traffic=spec.traffic,
                              device=torch.device("cuda"), mesh=None, rank=0, world=world)
        k = kind.Kind(ctx)
        variants = []
        if world == 1:  # over ranks, the program's readings are its runs' (run.py)
            k.setup()
            k.window(a.seconds)
            k.release()
            variants = ["program"]
        elif i < a.variants:
            k.inputs()
        if i < a.variants:
            variants += ["control", *kind.FAULTS]
            variants += list(getattr(kind, "MESH_FAULTS", ())) if world > 1 else []
        for v in variants:
            nums = k.check(v)
            readings.setdefault(v, []).append(nums)
            worst = {key: val for key, val in k.summary.items() if key.endswith("worst_leaf")}
            print(json.dumps({"seed": seed, "variant": v, **nums, **worst}), flush=True)
        del k
        gc.collect()
        torch.cuda.empty_cache()
    summary = {}
    for v, rows in readings.items():
        pick = max if v == "program" else min
        summary[v] = {n: pick(r[n] for r in rows) for n in rows[0]}
    print(json.dumps({"workload": a.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
