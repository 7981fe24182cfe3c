"""Model evaluation entry point (port of ``dl_biomass_tpu/eval/testing.py``) —
parity with the reference ``test_model`` (``testing_model.py:15-330``).

Differences by design, as in the JAX package:
  * "newest model" = newest checkpoint by epoch in ``model_dir``
    (``train/checkpoint.py``: ``epoch_*.pt``);
  * the model is rebuilt from the checkpoint's ``model_config.json`` sidecar
    (``models/pointnet2.model_from_dict``) instead of unpickling a live module;
  * inference runs the whole test set through the eval-mode module in
    fixed-size batches (the reference stuffs the entire set into one batch).

Returns ``(metrics_df, results_df)`` and saves the four figure families as PNG
where matplotlib is installed.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.eval.metrics import build_results_frame, metrics_table
from dl_biomass_tpu_torch.io.dataset import PointCloudsInFiles, PointCloudsInFilesPreSampled
from dl_biomass_tpu_torch.io.reader import read_las
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor, model_from_dict
from dl_biomass_tpu_torch.train.checkpoint import latest_checkpoint


def figure_module():
    """``eval/plots.py``, or None where matplotlib is not installed: the
    figures are then not written, and the caller says so."""
    if importlib.util.find_spec("matplotlib") is None:
        return None
    from dl_biomass_tpu_torch.eval import plots

    return plots


def load_model_for_eval(model_dir: str, model_file: Optional[str] = None,
                        parity: bool = False, device=None) -> Tuple[torch.nn.Module, str]:
    """(model in eval mode on ``device``, checkpoint path) from the newest
    (or given) checkpoint and the ``model_config.json`` beside it.

    ``parity=True`` overrides the inference-speed knobs with the reference-
    exact ones (f32, exact first-K ball query, no stratified grouping) — the
    parameters are dtype-independent, so any checkpoint can be evaluated in
    parity mode."""
    dev = resolve_device(device)
    path = model_file or latest_checkpoint(model_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoints under {model_dir!r}")
    with open(os.path.join(os.path.dirname(path), "model_config.json")) as f:
        mdict = dict(json.load(f)["model"])
    if parity and mdict.get("family", "pointnet2") == "voxelnet":
        mdict.update(compute_dtype="float32")  # no selection to make exact
    elif parity:
        # must match TrainConfig.apply_parity's model overrides exactly
        mdict.update(compute_dtype="float32", fast_group=False, fast_fps=False,
                     fused_sa=False, exact_selection=True, analytic_bn=False)
    model = model_from_dict(mdict)
    state = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(state["model"])
    return model.to(dev).eval(), path


@torch.inference_mode()
def predict_dataset(model: PointNet2Regressor, ds, batch_size: int = 32) -> np.ndarray:
    """Deterministic predictions (P, 4) over a DeviceDataset, in plot order:
    the eval-mode module forward over ``ds.batches`` (the metrics and parity
    path; the folded serving engine is ``models/inference.py``), every batch
    queued before the one host sync."""
    model.eval()
    outs = [model(b, train=False) for b in ds.batches(batch_size)]
    _, _, valids, _ = ds.epoch_spec_arrays(batch_size)
    return torch.cat(outs).cpu().numpy()[valids.reshape(-1)]


def test_model(
    model_file: Optional[str] = None,
    test_dataset_path: str = "",
    use_presampled: bool = True,
    point_cloud_vis: bool = False,
    use_columns: Optional[List[str]] = None,
    use_datasets: Optional[Sequence[str]] = None,
    num_points: int = 200,
    *,
    model_dir: str = "models_out",
    biomass_csv: Optional[str] = None,
    fig_out_dir: str = "figures_out",
    batch_size: int = 32,
    glob: str = "*.las",
    seed: int = 0,
    presampled_suffix: str = "_fps_7168",
    parity: bool = False,
    device=None,
) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Evaluate the newest (or given) checkpoint on a test directory, on
    ``device`` (None: the card, which must exist)."""
    if use_datasets is None:
        use_datasets = ["BC", "RM", "PF"]
    if use_columns is None:
        use_columns = ["intensity_normalized"]

    model, path = load_model_for_eval(model_dir, model_file, parity=parity, device=device)
    print("Using model:", path)
    dev = next(model.parameters()).device

    if use_presampled:
        fileset = PointCloudsInFilesPreSampled(
            test_dataset_path, glob, dataset=use_datasets,
            use_column=use_columns[0], biomass_csv=biomass_csv,
            presampled_suffix=presampled_suffix,
        )
        ds = fileset.load_all(for_augmentation=False, device=dev)
    else:
        fileset = PointCloudsInFiles(
            test_dataset_path, glob, max_points=num_points, use_columns=use_columns,
            filter_height=0.2, dataset=use_datasets, biomass_csv=biomass_csv,
        )
        ds = fileset.load_all(np.random.default_rng(seed), for_augmentation=False, device=dev)

    pred = predict_dataset(model, ds, batch_size)
    obs = ds.y.cpu().numpy()
    df = build_results_frame(obs, pred, ds.plot_ids)
    mdf = metrics_table(df)
    print(mdf)

    plots = figure_module()
    if plots is None:
        print(f"matplotlib is not installed: no figures written to {fig_out_dir}")
    else:
        plots.save_all_eval_figures(df, mdf, fig_out_dir)

    if point_cloud_vis and plots is not None:
        rng = np.random.default_rng(seed)
        pick = rng.choice(len(ds.plot_ids), size=min(4, len(ds.plot_ids)), replace=False)
        coords_list = []
        for i in pick:
            las_path = os.path.join(test_dataset_path, ds.plot_ids[i] + ".las")
            if not os.path.exists(las_path):  # presampled names carry a suffix
                las_path = str(fileset.files[i])
            c = read_las(las_path, get_attributes=False, filter_height=0)
            use_idx = rng.choice(c.shape[0], num_points, replace=c.shape[0] < num_points)
            c = c[use_idx]
            coords_list.append(c - c.mean(axis=0))
        plots.plot_cloud_grid(coords_list, os.path.join(fig_out_dir, "cloud_grid.png"))

    return mdf, df
