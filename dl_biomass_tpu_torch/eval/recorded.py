"""Recorded-fixture parity pathway (port of ``dl_biomass_tpu/eval/recorded.py``).

Freezes the complete LAS-bytes -> prediction pipeline in parity mode (f32,
exact FPS from the first valid point, exact first-K ball query, no stratified
grouping) over a corpus of LAS plots: any drift anywhere in the chain — LAS
decode, height filter, intensity normalization, subsampling, centering quirks,
model math — trips the frozen comparison. The JAX package committed such a
recording of ``tests/data/parity_fixture``.

    python -m dl_biomass_tpu_torch parity-record --data-dir <las_dir> \
        --biomass-csv <csv> --out recorded.json [--model-dir <ckpts>]
    python -m dl_biomass_tpu_torch parity-check  --data-dir <las_dir> \
        --biomass-csv <csv> --recorded recorded.json [--model-dir <ckpts>]

A recording names the framework that made it (``"framework": "torch"``; the
JAX package writes no such key, and its reader ignores it). Without
``--model-dir`` the parameters are each package's own seed init, and the two
inits differ: a recording the JAX package made from its seed init is replayed
here only with its parameters carried over (``bridge.from_flax_variables``,
saved as a checkpoint under ``--model-dir``); ``check_parity`` refuses it
otherwise, rather than reporting the other init as drift.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device

#: Relative tolerance for replaying a recording: the JAX package's. Parity mode
#: is f32 with a deterministic init, but another machine or another framework
#: sums the f32 matmuls in another order, and the reassociation can flip a
#: near-boundary ball-query membership or an FPS near-tie (measured ~2e-3 by
#: the JAX package across its machines). 1e-2 absorbs that while still
#: catching real semantic drift (a wrong filter/centering/selection rule moves
#: predictions by >>5e-2 on these clouds).
DEFAULT_RTOL = 1e-2

#: the ``framework`` key of the port's recordings
FRAMEWORK = "torch"


def _parity_model(num_features: int, model_dir: Optional[str], seed: int, device=None):
    """The parity-configured model in eval mode on ``device`` — from the
    newest checkpoint when ``model_dir`` is given, else the port's
    deterministic init from ``seed``."""
    from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor, seeded_init

    if model_dir:
        from dl_biomass_tpu_torch.eval.testing import load_model_for_eval

        model, _ = load_model_for_eval(model_dir, parity=True, device=device)
        return model
    model = seeded_init(seed, PointNet2Regressor, num_features=num_features,
                        compute_dtype=torch.float32, fast_group=False, fused_sa=False,
                        exact_selection=True)
    return model.to(resolve_device(device)).eval()


def _pipeline_predictions(
    data_dir: str,
    biomass_csv: str,
    *,
    model_dir: Optional[str],
    num_points: int,
    batch_size: int,
    seed: int,
    glob: str = "*.las",
    device=None,
) -> Tuple[list, np.ndarray, np.ndarray]:
    """Run LAS files -> parity predictions; returns (plot_ids, preds, targets)."""
    from dl_biomass_tpu_torch.eval.testing import predict_dataset
    from dl_biomass_tpu_torch.io.dataset import PointCloudsInFiles

    dev = resolve_device(device)
    fileset = PointCloudsInFiles(
        data_dir, glob, max_points=num_points,
        use_columns=["intensity_normalized"], filter_height=0.2,
        dataset=("BC", "RM", "PF"), biomass_csv=biomass_csv,
    )
    ds = fileset.load_all(np.random.default_rng(seed), for_augmentation=False, device=dev)
    model = _parity_model(1, model_dir, seed, dev)
    pred = predict_dataset(model, ds, batch_size)
    return list(ds.plot_ids), pred, ds.y.cpu().numpy()


def record_parity(
    data_dir: str,
    biomass_csv: str,
    out_json: str,
    *,
    model_dir: Optional[str] = None,
    num_points: int = 512,
    batch_size: int = 8,
    seed: int = 0,
    device=None,
) -> dict:
    """Freeze parity-mode predictions for every plot in ``data_dir``."""
    dev = resolve_device(device)
    ids, pred, y = _pipeline_predictions(
        data_dir, biomass_csv, model_dir=model_dir,
        num_points=num_points, batch_size=batch_size, seed=seed, device=dev,
    )
    rec = {
        "pipeline": "PointCloudsInFiles(filter_height=0.2) -> parity forward",
        "params": "checkpoint" if model_dir else f"seed-{seed} init",
        "framework": FRAMEWORK,
        "num_points": num_points,
        "batch_size": batch_size,
        "seed": seed,
        "backend": dev.type,
        "predictions": {pid: [float(v) for v in row] for pid, row in zip(ids, pred)},
        "targets": {pid: [float(v) for v in row] for pid, row in zip(ids, y)},
    }
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    return rec


def check_parity(
    data_dir: str,
    biomass_csv: str,
    recorded_json: str,
    *,
    model_dir: Optional[str] = None,
    rtol: float = DEFAULT_RTOL,
    device=None,
) -> float:
    """Replay the pipeline and compare against a recording.

    Returns the max relative deviation; raises AssertionError beyond ``rtol``
    or on any plot-set mismatch, and ValueError for a recording of another
    framework's seed init without ``model_dir``."""
    with open(recorded_json) as f:
        rec = json.load(f)
    framework = rec.get("framework", "jax")
    if model_dir is None and rec["params"] != "checkpoint" and framework != FRAMEWORK:
        raise ValueError(
            f"{recorded_json}: its parameters are the {framework} package's {rec['params']}, "
            f"which this package does not rebuild (its own init differs); pass --model-dir "
            f"with a checkpoint of those parameters (bridge.from_flax_variables)")
    ids, pred, _ = _pipeline_predictions(
        data_dir, biomass_csv, model_dir=model_dir,
        num_points=int(rec["num_points"]), batch_size=int(rec["batch_size"]),
        seed=int(rec["seed"]), device=device,
    )
    want = rec["predictions"]
    assert sorted(ids) == sorted(want), (
        f"plot set changed: pipeline {sorted(ids)} vs recorded {sorted(want)}"
    )
    max_rel = 0.0
    for pid, row in zip(ids, pred):
        w = np.asarray(want[pid], np.float64)
        scale = max(float(np.abs(w).max()), 1e-6)
        rel = float(np.abs(np.asarray(row, np.float64) - w).max() / scale)
        max_rel = max(max_rel, rel)
        assert rel <= rtol, (
            f"plot {pid}: prediction drifted {rel:.2e} (> rtol {rtol:.0e}) "
            f"from recording: got {np.asarray(row)}, recorded {w}"
        )
    return max_rel
