"""Multi-seed production-vs-parity numerics study (port of
``dl_biomass_tpu/experiments/seed_study.py``).

The production defaults trade exactness for speed (bf16 activations,
stratified SA1 grouping, sectored FPS); the parity preset keeps the
reference's literal numerics (f32, exact first-K selection —
``pointnet2_regressor.py:14-15``). A single training run cannot distinguish a
real accuracy cost from seed noise at this corpus size, so this experiment
runs full early-stopped trainings for N seeds per numerics mode on one fixed
synthetic corpus (``io/synthetic.py``) and reports val-MSE / held-out R²
mean ± sd per mode.

Modes:
  production           — bf16, fast_group, exact bq, EXACT FPS (fast_fps
                         forced off — this mode isolates the FPS question;
                         it is NOT the shipped default)
  production+fast_fps  — the shipped TrainConfig defaults (adds sectored
                         multi-start FPS)
  parity               — ``TrainConfig.apply_parity()`` numerics
  voxelnet             — the voxel-grid CNN family (``models/voxelnet.py``)
                         on the same corpus
  voxelnet_deep        — its capacity probe: a third conv (64, 128, 256)
  voxelnet_wide48      — its resolution probe: a 48³ grid, convs (96, 192)

Seeds: run ``seed`` draws its initial weights from ``seed``
(``models/pointnet2.seeded_init``) and its epochs from ``cfg.seed = 1000 + seed``, as
the JAX package draws them from ``key(seed)`` and ``key(1000 + seed)``.

Usage: ``python -m dl_biomass_tpu_torch seed-study --seeds 5 --out study.json``
"""

from __future__ import annotations

import copy
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.eval.metrics import r2_score

def _mode_config(base: TrainConfig, mode: str) -> TrainConfig:
    cfg = copy.deepcopy(base)
    if mode == "parity":
        return cfg.apply_parity()
    if mode == "production":
        cfg.model.fast_fps = False
        return cfg
    if mode == "production+fast_fps":
        cfg.model.fast_fps = True
        return cfg
    if mode == "voxelnet":
        cfg.model.family = "voxelnet"
        return cfg
    if mode == "voxelnet_deep":
        # a deeper conv stack: is the family's gap to the flagship
        # architecture or capacity
        cfg.model.family = "voxelnet"
        cfg.model.voxel_channels = [64, 128, 256]
        return cfg
    if mode == "voxelnet_wide48":
        # the resolution axis: a finer grid and wider convs
        cfg.model.family = "voxelnet"
        cfg.model.voxel_grid = 48
        cfg.model.voxel_channels = [96, 192]
        return cfg
    raise ValueError(f"unknown mode {mode!r}")


def run_seed_study(
    seeds: Sequence[int],
    modes: Sequence[str] = ("production", "production+fast_fps", "parity"),
    *,
    num_plots: int = 288,
    n_points: int = 4096,
    batch_size: int = 32,
    num_augs: int = 3,
    lr: float = 2e-3,
    patience: int = 8,
    max_epochs: int = 40,
    neuron_multiplier: int = 0,
    corpus_seed: int = 9999,
    out_json: Optional[str] = None,
    log_fn=print,
    device=None,
) -> Dict:
    """Train len(seeds) runs per mode on ONE fixed corpus; vary only the
    init/shuffle/augmentation seed. Returns (and optionally writes) a dict of
    per-run rows plus per-mode mean ± sd summaries. Trains on ``device``
    (None: the card, which must exist)."""
    from dl_biomass_tpu_torch.core.cloud import resolve_device
    from dl_biomass_tpu_torch.core.config import HyperParams
    from dl_biomass_tpu_torch.io.device_data import DeviceDataset
    from dl_biomass_tpu_torch.io.synthetic import synthetic_dataset
    from dl_biomass_tpu_torch.models.pointnet2 import build_model, seeded_init
    from dl_biomass_tpu_torch.train.trainer import Trainer

    dev = resolve_device(device)
    base = TrainConfig(
        hp=HyperParams(batch_size=batch_size, num_augs=num_augs, lr=lr,
                       patience=patience, num_points=n_points,
                       neuron_multiplier=neuron_multiplier)
    )
    base.num_epochs = max_epochs
    cfgs = {mode: _mode_config(base, mode) for mode in modes}  # refuse before any work

    pos, feat, ys, ids = synthetic_dataset(num_plots, n_points, seed=corpus_seed)
    n_val = n_test = max(num_plots // 6, 1)
    n_train = num_plots - n_val - n_test
    sl_train = slice(0, n_train)
    sl_val = slice(n_train, n_train + n_val)
    sl_test = slice(n_train + n_val, num_plots)

    def make_ds(sl):
        return DeviceDataset.from_clouds(pos[sl], feat[sl], ys[sl], ids[sl], device=dev)

    ds_train, ds_val, ds_test = make_ds(sl_train), make_ds(sl_val), make_ds(sl_test)
    y_test = ys[sl_test]

    rows: List[Dict] = []
    for mode in modes:
        for seed in seeds:
            cfg = copy.deepcopy(cfgs[mode])
            cfg.seed = 1000 + int(seed)
            model = seeded_init(int(seed), build_model, cfg, 1)
            trainer = Trainer(model, cfg, dev)
            t0 = time.time()
            hist = trainer.fit(ds_train, ds_val,  # on-device epochs
                               num_epochs=max_epochs, log_fn=lambda s: None)
            trainer.model.load_state_dict(hist["best_state"])
            pred = trainer.predict(ds_test.batches(batch_size))
            row = {
                "mode": mode,
                "seed": int(seed),
                "min_val_mse": float(np.min(hist["val_mse"])),
                "epochs": len(hist["epoch"]),
                "r2_total": r2_score(y_test.sum(1), pred.sum(1)),
                "r2_components": [r2_score(y_test[:, c], pred[:, c]) for c in range(4)],
                "wall_seconds": round(time.time() - t0, 1),
                "clouds_per_sec": float(np.mean(hist["clouds_per_sec"][1:]))
                if len(hist["clouds_per_sec"]) > 1 else float(hist["clouds_per_sec"][0]),
            }
            rows.append(row)
            log_fn(f"[seed-study] {mode} seed={seed}: val_mse={row['min_val_mse']:.4f} "
                   f"r2_total={row['r2_total']:.4f} ({row['epochs']} ep, "
                   f"{row['clouds_per_sec']:.0f} clouds/s)")

    summary = {}
    for mode in modes:
        sel = [r for r in rows if r["mode"] == mode]
        vm = np.array([r["min_val_mse"] for r in sel])
        r2 = np.array([r["r2_total"] for r in sel])
        summary[mode] = {
            "val_mse_mean": float(vm.mean()), "val_mse_sd": float(vm.std(ddof=1)) if len(vm) > 1 else 0.0,
            "r2_total_mean": float(r2.mean()), "r2_total_sd": float(r2.std(ddof=1)) if len(r2) > 1 else 0.0,
            "clouds_per_sec_mean": float(np.mean([r["clouds_per_sec"] for r in sel])),
        }
        log_fn(f"[seed-study] {mode}: val_mse {summary[mode]['val_mse_mean']:.4f}"
               f"±{summary[mode]['val_mse_sd']:.4f}  r2 {summary[mode]['r2_total_mean']:.4f}"
               f"±{summary[mode]['r2_total_sd']:.4f}")

    result = {
        "config": {
            "num_plots": num_plots, "n_points": n_points, "batch_size": batch_size,
            "num_augs": num_augs, "lr": lr, "patience": patience,
            "max_epochs": max_epochs, "corpus_seed": corpus_seed,
            "neuron_multiplier": neuron_multiplier,
            "seeds": [int(s) for s in seeds], "modes": list(modes),
        },
        "runs": rows,
        "summary": summary,
    }
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=1)
    return result
