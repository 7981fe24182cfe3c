"""The serving paths side by side (port of the JAX package's
``tools/serving_matrix.py``): the module's eval forward, the default engine
(``compile_inference``), the ``fused_eval`` engine (kernel 5) and the export
artifact (``models/export.export_serving`` then ``load_serving``), at B in
{1, 16, 36} x 10240, timed as the JAX tool times them: ``steps`` chained
calls ended by one synchronisation, best of ``repeats``. ``--cold`` times
process start to the predictions CSV of ``python -m dl_biomass_tpu_torch
predict --from-export`` on a directory of 36 presampled plots, in a
subprocess (the serving host's start: no model code, no checkpoint). Every
line names the card and its power limit.

    python -m dl_biomass_tpu_torch.tools.serving_matrix [--batches 1,16,36] [--device cpu]
    python -m dl_biomass_tpu_torch.tools.serving_matrix --cold [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.tools._timing import best_chain_s, card, flagship

N = 10240
BATCHES = (1, 16, 36)
TIMED_STEPS = 8
REPEATS = 5
COLD_PLOTS, COLD_POINTS = 36, 7168


def latency_matrix(batches=BATCHES, n: int = N, device=None, steps: int = TIMED_STEPS,
                   repeats: int = REPEATS) -> list:
    """ms a batch of each path at each B; a JSON line a batch."""
    from dl_biomass_tpu_torch.models.export import export_serving, load_serving
    from dl_biomass_tpu_torch.models.inference import compile_inference

    dev = resolve_device(device)
    where = card(dev)
    rows = []
    for b in batches:
        trainer, batch = flagship(b, n, dev)
        model = trainer.model.eval()
        paths = {"eval_step": lambda: trainer._eval_batch(batch),
                 "engine": compile_inference(model, dev).__call__,
                 "fused_eval_engine": compile_inference(model, dev, fused_eval=True).__call__}
        with tempfile.TemporaryDirectory() as art:
            export_serving(model, batch_size=b, num_points=n, path=art, device=dev)
            served = load_serving(art, dev)
            times = {}
            for name, fn in paths.items():
                call = fn if name == "eval_step" else (lambda fn=fn: fn(batch))
                times[name] = best_chain_s(call, dev, steps, repeats)
            times["export_artifact"] = best_chain_s(
                lambda: served(batch.pos, batch.feat, batch.mask), dev, steps, repeats)
        row = {"batch": b, "points": n, **{f"{k}_ms": v * 1e3 for k, v in times.items()},
               "winner": min(times, key=times.get), "card": where}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del trainer, batch, model, paths
    return rows


def cold_fixture(root: str, device, plots: int = COLD_PLOTS, points: int = COLD_POINTS) -> dict:
    """A directory of ``plots`` presampled LAS plots of ``points`` and an
    export artifact of the production model for batches of ``plots``."""
    from dl_biomass_tpu_torch.io.reader import write_las
    from dl_biomass_tpu_torch.io.synthetic import synthetic_plot
    from dl_biomass_tpu_torch.models.export import export_serving

    rng = np.random.default_rng(0)
    plot_dir = os.path.join(root, "plots")
    os.makedirs(plot_dir)
    for i in range(plots):
        coords, intensity, _ = synthetic_plot(rng, points)
        inorm = (intensity - intensity.min()) / max(float(np.ptp(intensity)), 1) * 20
        write_las(coords - coords.mean(axis=0),
                  os.path.join(plot_dir, f"RM_{i:03d}_fps_{points}.las"),
                  {"intensity_normalized": inorm.astype(np.float32)})
    trainer, _ = flagship(1, 8, device)
    art = os.path.join(root, "artifact")
    export_serving(trainer.model.eval(), batch_size=plots, num_points=points, path=art,
                   device=device)
    return {"plots": plot_dir, "artifact": art, "batch": plots, "points": points}


def cold_start(device=None, plots: int = COLD_PLOTS, points: int = COLD_POINTS) -> dict:
    """Process start to the predictions CSV from the artifact, in a
    subprocess; the row as a JSON line."""
    dev = resolve_device(device)
    root_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as root:
        fix = cold_fixture(root, dev, plots, points)
        out_csv = os.path.join(root, "preds.csv")
        cmd = [sys.executable, "-m", "dl_biomass_tpu_torch", "predict", "--from-export",
               fix["artifact"], "--in-dir", fix["plots"], "--out", out_csv, "--batch-size",
               str(fix["batch"]), "--num-points", str(points), "--presampled-suffix",
               f"_fps_{points}", "--plot-bucket", "0"] + (
                   [] if dev.type == "cuda" else ["--device", dev.type])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root_dir] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        ok = r.returncode == 0 and os.path.exists(out_csv)
        row = {"path": "from_export", "plots": plots, "points": points, "wall_s": wall,
               "ok": ok, "card": card(dev)}
        if ok:
            with open(out_csv) as f:
                row["rows"] = sum(1 for _ in f) - 1
        else:
            row["stderr_tail"] = r.stderr[-2000:]
    print(json.dumps(row), flush=True)
    return row


def main(batches=BATCHES, cold: bool = False, device=None, steps: int = TIMED_STEPS,
         repeats: int = REPEATS, n: int = N):
    """The latency matrix at ``batches`` x ``n``, or with ``cold`` the cold
    start."""
    if cold:
        return cold_start(device)
    return latency_matrix(batches, n, device, steps, repeats)


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="serving_matrix")
    p.add_argument("--cold", action="store_true", help="process start to the first predictions")
    p.add_argument("--batches", default=",".join(map(str, BATCHES)))
    p.add_argument("--device", default=None, help="cpu: the kernels' plain versions")
    a = p.parse_args()
    main([int(x) for x in a.batches.split(",")], a.cold, a.device)
