"""Deployment prediction: a directory of clouds -> a biomass CSV (port of
``dl_biomass_tpu/eval/predict.py``).

The reference has no target-free serving path — every eval script joins the
biomass table. This module loads a checkpoint, ingests LAS/parquet clouds,
runs them through the folded serving engine (``compile_dataset_inference``)
where the architecture has one, else through the eval-mode module
(``eval/testing.predict_dataset``), and writes ``PlotID,
bark/branch/foliage/wood_btphr, tree_btphr`` rows. With ``export_path`` it
serves through an artifact of ``models/export.py`` instead (no model, no
checkpoint), which chunks and pads the plots into its own envelope.
"""

from __future__ import annotations

import glob as _glob
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import pandas as pd

from dl_biomass_tpu_torch.eval.testing import load_model_for_eval, predict_dataset
from dl_biomass_tpu_torch.io.dataset import (BIOMASS_COLUMNS, PointCloudsInFiles,
                                             PointCloudsInFilesPreSampled)
from dl_biomass_tpu_torch.models.inference import compile_dataset_inference


def _targetless(fileset):
    """Serve datasets without a biomass table: zero targets (unused)."""
    fileset.targets = lambda plot_id: np.zeros(4, np.float32)
    return fileset


def _exported(export_path: Optional[str], device, log_fn=print):
    """The artifact at ``export_path`` on ``device``, or None."""
    if export_path is None:
        return None
    from dl_biomass_tpu_torch.models.export import load_serving

    exported = load_serving(export_path, device)
    log_fn(f"Using exported artifact: {export_path}")
    return exported


def _prefixes(in_dir: str, glob: str) -> List[str]:
    """Every filename prefix under ``in_dir``: deployment plots carry arbitrary
    names, not the training corpora's {BC, RM, PF}."""
    names = [os.path.basename(p) for p in _glob.glob(os.path.join(in_dir, glob))]
    return sorted({n.split(".")[0][:2] for n in names}) or ["BC"]


def _fileset(in_dir, glob, datasets, use_presampled, use_columns, presampled_suffix,
             num_points):
    if use_presampled:
        return _targetless(PointCloudsInFilesPreSampled(
            in_dir, glob, dataset=datasets, use_column=use_columns[0],
            presampled_suffix=presampled_suffix))
    return _targetless(PointCloudsInFiles(
        in_dir, glob, max_points=num_points, use_columns=use_columns, filter_height=0.2,
        dataset=datasets))


def _load(fileset, use_presampled: bool, seed: int, device):
    if use_presampled:
        return fileset.load_all(for_augmentation=False, device=device)
    return fileset.load_all(np.random.default_rng(seed), for_augmentation=False, device=device)


def _engine(model, device):
    """``compile_dataset_inference`` where the engine covers the architecture,
    else None (the eval-mode module serves)."""
    try:
        return compile_dataset_inference(model, device)
    except NotImplementedError:
        return None


def _serve(ds, n_real: int, plot_bucket: int, serve_ds, model, batch_size: int,
           exported=None) -> np.ndarray:
    """(n_real, 4) rows in plot order; the plot count rounded up to a multiple
    of ``plot_bucket`` (0: not) with zero-mask plots, whose rows are dropped.
    An artifact chunks and pads into its own envelope."""
    if exported is not None:
        return exported.predict(ds.pos, ds.feat, ds.mask)[:n_real]
    if plot_bucket and plot_bucket > 0:
        ds = ds.pad_plots(-(-n_real // plot_bucket) * plot_bucket)
    pred = serve_ds(ds, batch_size) if serve_ds is not None else predict_dataset(
        model, ds, batch_size)
    return pred[:n_real]


def predict_directory(
    model_dir: str,
    in_dir: str,
    out_csv: Optional[str] = None,
    *,
    model_file: Optional[str] = None,
    use_presampled: bool = True,
    num_points: int = 7168,
    use_columns: Optional[List[str]] = None,
    use_datasets: Optional[Sequence[str]] = None,
    glob: str = "*.las",
    batch_size: int = 32,
    presampled_suffix: str = "_fps_7168",
    parity: bool = False,
    engine: bool = True,
    seed: int = 0,
    plot_bucket: int = 64,
    export_path: Optional[str] = None,
    device=None,
) -> pd.DataFrame:
    """Predict every plot under ``in_dir`` on ``device`` (None: the card);
    returns (and optionally writes) the predictions frame indexed by PlotID.

    ``engine`` (and not ``parity``) serves through the folded engine,
    otherwise through the eval-mode module. ``plot_bucket``: round the served
    plot count up to a multiple of this (padded plots are masked out and
    their rows dropped), so that directories of sizes in one bucket run the
    same batch shapes; 0 disables. ``export_path``: serve through an artifact
    of ``export-model`` instead of a checkpoint (``model_dir``, ``parity``
    and ``engine`` are ignored)."""
    use_columns = use_columns or ["intensity_normalized"]
    if use_datasets is None:
        use_datasets = _prefixes(in_dir, glob)
    exported = _exported(export_path, device)
    model = serve_ds = None
    if exported is None:
        model, path = load_model_for_eval(model_dir, model_file, parity=parity, device=device)
        print("Using model:", path)
        dev = next(model.parameters()).device
    else:
        dev = exported.device

    fileset = _fileset(in_dir, glob, use_datasets, use_presampled, use_columns,
                       presampled_suffix, num_points)
    if len(fileset) == 0:
        raise FileNotFoundError(f"no {glob} plots under {in_dir!r}")
    ds = _load(fileset, use_presampled, seed, dev)
    if exported is None and engine and not parity:
        serve_ds = _engine(model, dev)
    pred = _serve(ds, len(ds), plot_bucket, serve_ds, model, batch_size, exported)

    df = pd.DataFrame(pred, columns=list(BIOMASS_COLUMNS), index=list(ds.plot_ids))
    df.index.name = "PlotID"
    df["tree_btphr"] = df[list(BIOMASS_COLUMNS)].sum(axis=1)
    if out_csv:
        os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
        df.to_csv(out_csv)
    return df


def watch_directory(
    model_dir: str,
    in_dir: str,
    out_csv: str,
    *,
    poll_seconds: float = 10.0,
    max_polls: Optional[int] = None,
    model_file: Optional[str] = None,
    use_presampled: bool = True,
    num_points: int = 7168,
    use_columns: Optional[List[str]] = None,
    glob: str = "*.las",
    batch_size: int = 32,
    presampled_suffix: str = "_fps_7168",
    plot_bucket: int = 64,
    seed: int = 0,
    log_fn=print,
    export_path: Optional[str] = None,
    device=None,
) -> int:
    """Long-running serving: poll ``in_dir`` and predict plots not yet in
    ``out_csv``, appending rows as they arrive.

    The model and the folded engine stay warm in-process, so the marginal
    cost of a new plot is its decode and its share of a batch. Restart-safe:
    PlotIDs already in ``out_csv`` are skipped. Returns the number of plots
    predicted. ``export_path``: serve from an artifact of ``export-model``."""
    use_columns = use_columns or ["intensity_normalized"]
    exported = _exported(export_path, device, log_fn)
    model = serve_ds = None
    if exported is None:
        model, path = load_model_for_eval(model_dir, model_file, device=device)
        log_fn(f"watching {in_dir!r} with model {path}")
        dev = next(model.parameters()).device
        serve_ds = _engine(model, dev)
    else:
        dev = exported.device

    seen: set = set()
    if os.path.exists(out_csv):
        seen = set(pd.read_csv(out_csv, usecols=["PlotID"])["PlotID"].astype(str))
        log_fn(f"resuming: {len(seen)} plots already in {out_csv}")
    else:
        os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
        with open(out_csv, "w") as f:
            f.write("PlotID," + ",".join(BIOMASS_COLUMNS) + ",tree_btphr\n")

    total = 0
    polls = 0
    while True:
        fileset = _fileset(in_dir, glob, _prefixes(in_dir, glob), use_presampled, use_columns,
                           presampled_suffix, num_points)
        fileset.files = [f for i, f in enumerate(fileset.files)
                         if fileset.plot_id(i) not in seen]
        if fileset.files:
            ds = _load(fileset, use_presampled, seed, dev)
            ids = list(ds.plot_ids)
            pred = np.asarray(_serve(ds, len(ds), plot_bucket, serve_ds, model, batch_size,
                                     exported), np.float32)
            with open(out_csv, "a") as f:
                for pid, row in zip(ids, pred):
                    f.write(f"{pid}," + ",".join(f"{v}" for v in row) + f",{row.sum()}\n")
            seen.update(ids)
            total += len(ids)
            log_fn(f"predicted {len(ids)} new plots ({total} total)")
        polls += 1
        if max_polls is not None and polls >= max_polls:
            return total
        time.sleep(poll_seconds)
