"""Point-density ablation: train a full model per points-per-cloud setting
(port of ``dl_biomass_tpu/experiments/density.py``).

Parity with the reference ``point_density_effect.py:20-172``: for each density in
``range(500, 10000, 500)`` train with early stopping, record the minimum val MSE
and the wall-clock runtime, and write a CSV ``point_num, val_mse, runtime``.

Differences by design, as in the JAX package: the loss is the 4-component
weighted MSE of the main path (the reference script still used the stale
scalar-target loss, ``point_density_effect.py:59-60`` — flagged in SURVEY.md
§7 as a bug not to reproduce), and per-density throughput (clouds/sec) is
recorded alongside runtime.

The subsampling draws come from ``np.random.default_rng(seed)`` in the JAX
package's order, so both packages train on the same points. Density
``point_num`` trains from ``seed + point_num``: the initial weights
(``models/pointnet2.seeded_init``) and the epochs' draws (``cfg.seed``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional, Sequence

import numpy as np
import pandas as pd


def point_density_effect(
    pos_list: Sequence[np.ndarray],
    feat_list: Sequence[np.ndarray],
    y: np.ndarray,
    plot_ids: Sequence[str],
    *,
    point_range: Iterable[int] = range(500, 10000, 500),
    cfg=None,
    num_epochs: int = 200,
    val_fraction: float = 0.25,
    out_csv: Optional[str] = None,
    seed: int = 0,
    log_fn=print,
    device=None,
) -> pd.DataFrame:
    """Run the ablation over full clouds (each >= max(point_range) points, or
    they are upsampled with replacement like the reference loader), training
    on ``device`` (None: the card, which must exist)."""
    from dl_biomass_tpu_torch.core.cloud import resolve_device
    from dl_biomass_tpu_torch.core.config import HyperParams, TrainConfig
    from dl_biomass_tpu_torch.io.device_data import DeviceDataset
    from dl_biomass_tpu_torch.models.pointnet2 import build_model, seeded_init
    from dl_biomass_tpu_torch.train.trainer import Trainer

    dev = resolve_device(device)
    if cfg is None:
        # the reference ablation's alternate tuned set (point_density_effect.py:23-33)
        cfg = TrainConfig(
            hp=HyperParams(lr=0.0005753187813135093, batch_size=28, num_augs=1,
                           patience=28, dropout_probability=0.55),
            num_epochs=num_epochs,
        )

    rng = np.random.default_rng(seed)
    n_val = max(1, int(len(pos_list) * val_fraction))
    perm = rng.permutation(len(pos_list))
    val_ids, train_ids = perm[:n_val], perm[n_val:]

    rows = []
    for point_num in point_range:
        t0 = time.time()

        def subsample(i):
            p, f = pos_list[i], feat_list[i]
            idx = rng.choice(len(p), point_num, replace=len(p) < point_num)
            return p[idx], f[idx]

        tr = [subsample(i) for i in train_ids]
        va = [subsample(i) for i in val_ids]
        ds_tr = DeviceDataset.from_clouds(
            [t[0] for t in tr], [t[1] for t in tr], y[train_ids],
            [plot_ids[i] for i in train_ids], base_n=point_num, device=dev,
        )
        ds_va = DeviceDataset.from_clouds(
            [v[0] for v in va], [v[1] for v in va], y[val_ids],
            [plot_ids[i] for i in val_ids], base_n=point_num, for_augmentation=False,
            device=dev,
        )

        run_cfg = dataclasses.replace(cfg, seed=seed + point_num)
        model = seeded_init(seed + point_num, build_model, run_cfg, ds_tr.num_features)
        trainer = Trainer(model, run_cfg, dev)
        hist = trainer.fit(ds_tr, ds_va,  # datasets -> on-device epochs
                           num_epochs=run_cfg.num_epochs, log_fn=lambda s: None)
        runtime = time.time() - t0
        rows.append(
            dict(
                point_num=point_num,
                val_mse=hist["best_val_mse"],
                runtime=runtime,
                clouds_per_sec=float(np.mean(hist["clouds_per_sec"])),
                epochs=len(hist["epoch"]),
            )
        )
        log_fn(
            f"density {point_num}: val MSE {hist['best_val_mse']:.3f} "
            f"in {runtime:.1f}s ({rows[-1]['clouds_per_sec']:.0f} clouds/s)"
        )

    df = pd.DataFrame(rows)
    if out_csv:
        df.to_csv(out_csv, index=False)
    return df
