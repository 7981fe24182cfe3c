"""Command-line interface of the PyTorch port (port of ``dl_biomass_tpu/__main__.py``).

    python -m dl_biomass_tpu_torch resample --in-dir ... --out-dir ... --method fps --engine cuda
    python -m dl_biomass_tpu_torch train    --config cfg.json [--hp.lr 1e-3 ...]
    python -m dl_biomass_tpu_torch evaluate --config cfg.json --model-dir ...
    python -m dl_biomass_tpu_torch predict  --model-dir ... --in-dir ... --out preds.csv
    python -m dl_biomass_tpu_torch export-model --model-dir ... --out artifact/
    python -m dl_biomass_tpu_torch predict  --from-export artifact/ --in-dir ... --out preds.csv
    torchrun --nproc-per-node N -m dl_biomass_tpu_torch train --config cfg.json
    python -m dl_biomass_tpu_torch sweep    --config cfg.json --lrs 1e-4,1e-3 --wds 0,8e-5
    python -m dl_biomass_tpu_torch tune     --config cfg.json --n-trials 20 [--continue-study]
    python -m dl_biomass_tpu_torch density  --data.train_dir ... --data.biomass_csv ...
    python -m dl_biomass_tpu_torch seed-study --seeds 5 --out study.json
    python -m dl_biomass_tpu_torch visualize-aug --las file.las --out fig.png
    python -m dl_biomass_tpu_torch parity-record --data-dir ... --biomass-csv ... --out rec.json
    python -m dl_biomass_tpu_torch parity-check  --data-dir ... --biomass-csv ... --recorded rec.json

Any config knob is overridable with dotted flags (``--hp.batch_size 16``) or
top-level TrainConfig fields (``--num_epochs 2``). Every subcommand runs on
the card; ``--device cpu`` runs the kernels' plain versions on the CPU
instead. Without a card and without that flag, they raise. Under ``torchrun``
with more than one process, ``train`` trains over ``make_mesh(mesh.dp,
mesh.mp)``: each rank its ``dp`` slice of every batch, a card each where
there are enough, else sharing one.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List

from dl_biomass_tpu_torch.core.config import TrainConfig

_TOP_LEVEL_KEYS = {f.name for f in dataclasses.fields(TrainConfig)}

# the subcommands of the JAX CLI that wait for a module of the port: none
UNPORTED: dict = {}


def _split_overrides(argv: List[str]) -> tuple:
    """Separate config overrides (dotted paths like ``--hp.lr`` or top-level
    TrainConfig fields like ``--num_epochs``) from the subcommand's own flags."""
    own, overrides = [], []
    i = 0
    while i < len(argv):
        a = argv[i]
        key = a[2:].split("=")[0] if a.startswith("--") else ""
        if a.startswith("--") and ("." in key or key in _TOP_LEVEL_KEYS):
            if "=" in a:
                overrides.append(a)
                i += 1
            else:
                overrides += [a, argv[i + 1] if i + 1 < len(argv) else ""]
                i += 2
        else:
            own.append(a)
            i += 1
    return own, overrides


def _device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the kernels' plain "
                        "versions)")


def _load_cfg(args, overrides) -> TrainConfig:
    cfg = TrainConfig.from_json(args.config) if getattr(args, "config", None) else TrainConfig()
    if overrides:
        cfg = cfg.with_overrides(overrides)
    if getattr(args, "parity", False):
        cfg = cfg.apply_parity()
    return cfg


def _load_train_val(cfg: TrainConfig, device):
    import numpy as np

    from dl_biomass_tpu_torch.io.dataset import PointCloudsInFiles, PointCloudsInFilesPreSampled

    d = cfg.data
    if d.use_presampled:
        def mk(path):
            return PointCloudsInFilesPreSampled(
                path, d.glob, dataset=d.use_datasets, use_column=d.use_columns[0],
                biomass_csv=d.biomass_csv, presampled_suffix=d.presampled_suffix,
            ).load_all(device=device)
        return mk(d.train_dir), mk(d.val_dir)
    rng = np.random.default_rng(cfg.seed)

    def mk(path):
        return PointCloudsInFiles(
            path, d.glob, max_points=cfg.hp.num_points, use_columns=d.use_columns,
            filter_height=cfg.hp.ground_filter_height, dataset=d.use_datasets,
            biomass_csv=d.biomass_csv,
        ).load_all(rng, device=device)
    return mk(d.train_dir), mk(d.val_dir)


def cmd_train(argv):
    p = argparse.ArgumentParser(prog="train")
    p.add_argument("--config")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--parity", action="store_true",
                   help="reference-exact numerics: f32 + exact first-K ball query")
    _device_flag(p)
    own, overrides = _split_overrides(argv)
    args = p.parse_args(own)
    cfg = _load_cfg(args, overrides)

    import contextlib
    import io

    from dl_biomass_tpu_torch.core.cloud import resolve_device
    from dl_biomass_tpu_torch.parallel import mesh as dp

    mesh = None
    if _world_size() > 1:  # under torchrun: a mesh, as the JAX CLI takes one over >1 device
        device = dp.init_from_env(args.device)
        mesh = dp.make_mesh(cfg.mesh.dp, cfg.mesh.mp, device)
    else:
        device = resolve_device(args.device)
    # under a mesh rank 0 prints, writes and evaluates; the others train quietly
    with (contextlib.nullcontext() if dp.is_writer(mesh) else
          contextlib.redirect_stdout(io.StringIO())):
        _train(args, cfg, device, mesh)


def _train(args, cfg: TrainConfig, device, mesh) -> None:
    import torch

    from dl_biomass_tpu_torch.eval.testing import figure_module
    from dl_biomass_tpu_torch.models.pointnet2 import build_model
    from dl_biomass_tpu_torch.parallel import mesh as dp
    from dl_biomass_tpu_torch.train.trainer import Trainer

    print(f"Dataset(s): {cfg.data.use_datasets}")
    print(f"Additional features used: {cfg.data.use_columns}")
    print(f"Using {cfg.hp.num_points} points per plot")
    print(f"Early stopping: {cfg.early_stopping}")
    print(f"Max number of epochs: {cfg.num_epochs}")
    print(f"Device: {device}" + (f", mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                                 if mesh is not None else ""))
    print("\nHyperparameters:")
    for k, v in vars(cfg.hp).items():
        print(f"  {k}: {v}")

    ds_train, ds_val = _load_train_val(cfg, device)
    print(f"\n{len(ds_train)} train / {len(ds_val)} val plots "
          f"({1 + cfg.hp.num_augs}x train samples with augmentation)")

    torch.manual_seed(cfg.seed)  # the initial weights, as the JAX CLI draws them from cfg.seed
    model = build_model(cfg, num_features=ds_train.num_features)
    trainer = Trainer(model, cfg, device, mesh=mesh)

    writer = None
    if args.tensorboard and dp.is_writer(mesh):
        from dl_biomass_tpu_torch.utils.tboard import SummaryWriter

        writer = SummaryWriter(comment=f"_{cfg.hp.num_points}_pts_lr_{cfg.hp.lr}")

    os.makedirs(cfg.model_dir, exist_ok=True)
    log_csv = os.path.join(cfg.model_dir, "training_log.csv")
    try:
        hist = trainer.fit(ds_train, ds_val, csv_path=log_csv, checkpoint_dir=cfg.model_dir,
                           metric_writer=writer)
    finally:
        if writer is not None:
            writer.close()
    if not dp.is_writer(mesh):
        return
    plots = figure_module()
    if plots is None:
        print("matplotlib is not installed: mse_curves.png not written")
    else:
        plots.plot_mse_curves(log_csv, os.path.join(cfg.model_dir, "mse_curves.png"))
    print(f"\nBest val MSE: {hist['best_val_mse']:.4f} "
          f"(mean {sum(hist['clouds_per_sec'])/len(hist['clouds_per_sec']):.0f} clouds/s)")

    if cfg.data.test_dir:
        from dl_biomass_tpu_torch.eval.testing import test_model

        test_model(
            test_dataset_path=cfg.data.test_dir, use_presampled=cfg.data.use_presampled,
            use_columns=cfg.data.use_columns, use_datasets=cfg.data.use_datasets,
            num_points=cfg.hp.num_points, model_dir=cfg.model_dir,
            biomass_csv=cfg.data.biomass_csv,
            fig_out_dir=os.path.join(cfg.model_dir, "figures"),
            presampled_suffix=cfg.data.presampled_suffix, device=device,
        )


def cmd_evaluate(argv):
    p = argparse.ArgumentParser(prog="evaluate")
    p.add_argument("--config")
    p.add_argument("--parity", action="store_true",
                   help="reference-exact numerics: f32 + exact first-K ball query")
    p.add_argument("--model-dir", default="models_out")
    p.add_argument("--model-file")
    p.add_argument("--fig-out-dir", default="figures_out")
    p.add_argument("--point-cloud-vis", action="store_true")
    _device_flag(p)
    own, overrides = _split_overrides(argv)
    args = p.parse_args(own)
    cfg = _load_cfg(args, overrides)

    from dl_biomass_tpu_torch.eval.testing import test_model

    test_model(
        model_file=args.model_file,
        test_dataset_path=cfg.data.test_dir,
        use_presampled=cfg.data.use_presampled,
        point_cloud_vis=args.point_cloud_vis,
        use_columns=cfg.data.use_columns,
        use_datasets=cfg.data.use_datasets,
        num_points=cfg.hp.num_points,
        model_dir=args.model_dir,
        biomass_csv=cfg.data.biomass_csv,
        fig_out_dir=args.fig_out_dir,
        presampled_suffix=cfg.data.presampled_suffix,
        parity=args.parity,
        device=args.device,
    )


def cmd_resample(argv):
    from dl_biomass_tpu_torch.io.resample import ENGINES

    p = argparse.ArgumentParser(prog="resample")
    p.add_argument("--in-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--num-points", type=int, default=7168)
    p.add_argument("--method", choices=["random", "fps", "voxel"], default="fps")
    p.add_argument("--format", choices=["parquet", "las"], default="parquet")
    p.add_argument("--engine", choices=ENGINES, default="auto")
    p.add_argument("--check", action="store_true", help="render 4 random outputs")
    _device_flag(p)
    args = p.parse_args(argv)

    from dl_biomass_tpu_torch.io.resample import check_resampling, resample_point_clouds

    written = resample_point_clouds(
        args.in_dir, args.out_dir, args.num_points, samp_meth=args.method,
        use_parquet=args.format == "parquet", engine=args.engine, device=args.device,
    )
    print(f"wrote {len(written)} files to {args.out_dir}")
    if args.check:
        check_resampling(args.out_dir, os.path.join(args.out_dir, "check_resampling.png"))


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def cmd_export_model(argv):
    """Serving export: a checkpoint -> an artifact that serves without the
    model code (``models/export.py``), the counterpart of the reference's
    whole-module ``torch.save`` pickles (``main.py:243-245``)."""
    p = argparse.ArgumentParser(prog="export-model")
    p.add_argument("--model-dir", default="models_out")
    p.add_argument("--model-file")
    p.add_argument("--out", required=True, help="artifact directory to write")
    p.add_argument("--batch-size", type=int, default=36)
    p.add_argument("--num-points", type=int, default=7168,
                   help="served point-axis size; rounded up to the 128-point capacity the "
                        "datasets produce")
    p.add_argument("--device", default=None,
                   help="the device the artifact serves on (default: the card; 'cpu' exports "
                        "the kernels' plain versions)")
    args = p.parse_args(argv)

    from dl_biomass_tpu_torch.core.cloud import round_up
    from dl_biomass_tpu_torch.eval.testing import load_model_for_eval
    from dl_biomass_tpu_torch.models.export import export_serving

    model, path = load_model_for_eval(args.model_dir, args.model_file, device=args.device)
    print("Exporting model:", path)
    meta = export_serving(model, batch_size=args.batch_size,
                          num_points=round_up(args.num_points, 128), path=args.out,
                          device=args.device)
    print(f"wrote artifact -> {args.out} (platforms {meta['platforms']}, envelope "
          f"{meta['batch_size']}x{meta['num_points']}x{meta['num_features']})")


def cmd_predict(argv):
    """Target-free serving: a directory of clouds -> a predictions CSV."""
    p = argparse.ArgumentParser(prog="predict")
    p.add_argument("--model-dir", default="models_out")
    p.add_argument("--model-file")
    p.add_argument("--in-dir", required=True)
    p.add_argument("--out", required=True, help="predictions CSV path")
    p.add_argument("--glob", default="*.las")
    p.add_argument("--datasets", default=None,
                   help="comma-separated 2-char filename prefixes to keep "
                        "(default: every prefix present in --in-dir)")
    p.add_argument("--presampled", default="true",
                   help="true: already-resampled clouds (load all points); "
                        "false: raw LAS (height filter + random subsample)")
    p.add_argument("--num-points", type=int, default=7168)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--presampled-suffix", default="_fps_7168")
    p.add_argument("--parity", action="store_true",
                   help="reference-exact numerics (disables the serving engine)")
    p.add_argument("--no-engine", action="store_true",
                   help="serve through the eval-mode module instead of the folded engine")
    p.add_argument("--plot-bucket", type=int, default=64,
                   help="round the served plot count up to a multiple of this so "
                        "same-bucket directory sizes run the same batch shapes (0 disables)")
    p.add_argument("--from-export", default=None, metavar="DIR",
                   help="serve through an artifact written by `export-model` instead of a "
                        "checkpoint (--model-dir is ignored)")
    p.add_argument("--watch", action="store_true",
                   help="keep running: poll --in-dir and append predictions "
                        "for newly arriving plots (restart-safe; the engine "
                        "stays warm in-process)")
    p.add_argument("--poll-seconds", type=float, default=10.0)
    p.add_argument("--max-polls", type=int, default=None,
                   help="stop after N polls (default: run until killed)")
    _device_flag(p)
    args = p.parse_args(argv)
    presampled = args.presampled.lower() in ("1", "true", "yes")

    if args.watch:
        from dl_biomass_tpu_torch.eval.predict import watch_directory

        n = watch_directory(
            args.model_dir, args.in_dir, args.out,
            poll_seconds=args.poll_seconds, max_polls=args.max_polls,
            model_file=args.model_file, use_presampled=presampled,
            num_points=args.num_points, glob=args.glob, batch_size=args.batch_size,
            presampled_suffix=args.presampled_suffix, plot_bucket=args.plot_bucket,
            export_path=args.from_export, device=args.device,
        )
        print(f"watch ended: {n} plots predicted -> {args.out}")
        return

    from dl_biomass_tpu_torch.eval.predict import predict_directory

    df = predict_directory(
        args.model_dir, args.in_dir, args.out,
        model_file=args.model_file, use_presampled=presampled,
        use_datasets=args.datasets.split(",") if args.datasets else None,
        num_points=args.num_points, glob=args.glob,
        batch_size=args.batch_size, presampled_suffix=args.presampled_suffix,
        parity=args.parity, engine=not args.no_engine,
        plot_bucket=args.plot_bucket, export_path=args.from_export, device=args.device,
    )
    print(f"wrote {len(df)} predictions -> {args.out}")


def cmd_sweep(argv):
    """The (lr x wd) x batch-size grid, each grid's trials in turn on every
    shared batch (``sweep/vmapped.py``); writes the study JSON and its
    ``_trials.csv``."""
    p = argparse.ArgumentParser(prog="sweep")
    p.add_argument("--config")
    p.add_argument("--lrs", default="1e-4,3e-4,1e-3,3e-3")
    p.add_argument("--wds", default="8.025e-5")
    p.add_argument("--batch-sizes", default="36")
    p.add_argument("--num-epochs", type=int, default=100)
    p.add_argument("--study-out", default="studies/sweep.json")
    _device_flag(p)
    own, overrides = _split_overrides(argv)
    args = p.parse_args(own)
    cfg = _load_cfg(args, overrides)

    from dl_biomass_tpu_torch.core.cloud import resolve_device
    from dl_biomass_tpu_torch.models.pointnet2 import build_model
    from dl_biomass_tpu_torch.sweep import create_study
    from dl_biomass_tpu_torch.sweep.vmapped import grid_sweep

    device = resolve_device(args.device)
    ds_train, ds_val = _load_train_val(cfg, device)
    model = build_model(cfg, num_features=ds_train.num_features)  # the trials' architecture
    study = create_study(study_name="vmapped_sweep")
    lrs = [float(x) for x in args.lrs.split(",")]
    wds = [float(x) for x in args.wds.split(",")]
    results = grid_sweep(
        model, ds_train, ds_val, lrs=lrs, wds=wds,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        num_augs=cfg.hp.num_augs, num_epochs=args.num_epochs,
        patience=cfg.hp.patience, optimizer=cfg.hp.optimizer,
        seed=cfg.seed, study=study, device=device,
    )
    study.save(args.study_out)
    best = min(results, key=lambda r: r.best_val_mse)
    print(f"\nBest trial: lr={best.lr} wd={best.weight_decay} "
          f"batch={best.batch_size} -> val MSE {best.best_val_mse:.4f}")
    print(f"Study saved to {args.study_out}")
    df = study.trials_dataframe()
    df.to_csv(os.path.splitext(args.study_out)[0] + "_trials.csv", index=False)


def _param_importances(study):
    """``study.get_param_importances()``, or None where scikit-learn (its
    random forest) is not installed."""
    import importlib.util

    if importlib.util.find_spec("sklearn") is None:
        return None
    return study.get_param_importances()


def cmd_tune(argv):
    """Sequential TPE study over the reference's search space (the reference's
    ``hyperparameter_tuning.py`` surface; see ``sweep`` for the grid)."""
    p = argparse.ArgumentParser(prog="tune")
    p.add_argument("--config")
    p.add_argument("--n-trials", type=int, default=20)
    p.add_argument("--timeout", type=float, default=None, help="seconds")
    p.add_argument("--max-epochs", type=int, default=100)
    p.add_argument("--study-out", default="studies/tune.json")
    p.add_argument("--continue-study", action="store_true")
    p.add_argument("--no-pruning", action="store_true")
    p.add_argument("--catch-failures", action="store_true",
                   help="mark a crashed trial FAILED and continue the study "
                        "(Optuna catch=(Exception,)): a fault costs one trial, not the run")
    _device_flag(p)
    own, overrides = _split_overrides(argv)
    args = p.parse_args(own)
    cfg = _load_cfg(args, overrides)

    from dl_biomass_tpu_torch.core.cloud import resolve_device
    from dl_biomass_tpu_torch.eval.testing import figure_module
    from dl_biomass_tpu_torch.sweep import MedianPruner, TPESampler, create_study, load_study
    from dl_biomass_tpu_torch.sweep.objective import make_training_objective
    from dl_biomass_tpu_torch.sweep.study import newest_study

    device = resolve_device(args.device)
    ds_train, ds_val = _load_train_val(cfg, device)
    study = None
    if args.continue_study:
        prev = newest_study(os.path.dirname(args.study_out) or ".")
        if prev:
            study = load_study(prev, sampler=TPESampler(seed=cfg.seed),
                               pruner=None if args.no_pruning else MedianPruner())
            print(f"Continuing study: {prev} ({len(study.trials)} trials)")
    if study is None:
        study = create_study(sampler=TPESampler(seed=cfg.seed),
                             pruner=None if args.no_pruning else MedianPruner(),
                             study_name="tune")
    objective = make_training_objective(
        ds_train, ds_val, base_cfg=cfg, max_num_epochs=args.max_epochs, seed=cfg.seed,
        device=device,
    )
    try:
        study.optimize(objective, n_trials=args.n_trials, timeout=args.timeout,
                       catch=(Exception,) if args.catch_failures else ())
    finally:
        # a failing trial re-raises out of optimize — persist the completed
        # trials either way; a save failure must not mask the trial's own exception
        try:
            study.save(args.study_out)
        except Exception as e:
            print(f"WARNING: could not save study to {args.study_out}: {e}",
                  file=sys.stderr)
    print("Best trial:")
    print("  Value: ", study.best_value)
    for k, v in study.best_params.items():
        print(f"    {k}: {v}")
    study.trials_dataframe().to_csv(os.path.splitext(args.study_out)[0] + "_trials.csv",
                                    index=False)
    imp = _param_importances(study)
    if imp is None:
        print("scikit-learn is not installed: parameter importances and their figure skipped")
        return
    print("Param importances:", {k: round(v, 3) for k, v in imp.items()})
    if imp:
        # splitext, not str.replace: a suffix-less --study-out must not make the
        # PNG path collide with (and overwrite) the study JSON written above
        png = os.path.splitext(args.study_out)[0] + "_param_importances.png"
        plots = figure_module()
        if plots is None:
            print(f"matplotlib is not installed: {png} not written")
        else:
            plots.plot_param_importances(imp, png)
            print(f"Wrote {png}")


def cmd_density(argv):
    p = argparse.ArgumentParser(prog="density")
    p.add_argument("--config")
    p.add_argument("--out-csv", default="point_density_effect.csv")
    p.add_argument("--range", default="500:10000:500")
    _device_flag(p)
    own, overrides = _split_overrides(argv)
    args = p.parse_args(own)
    cfg = _load_cfg(args, overrides)

    import numpy as np

    from dl_biomass_tpu_torch.core.cloud import resolve_device
    from dl_biomass_tpu_torch.experiments.density import point_density_effect
    from dl_biomass_tpu_torch.io.dataset import PointCloudsInFiles

    device = resolve_device(args.device)
    lo, hi, step = (int(x) for x in args.range.split(":"))
    # Training HPs: the reference ablation runs its own alternate tuned set
    # (point_density_effect.py:23-33), which is the default here (cfg=None).
    # A --config or any --hp.* override asks for explicit control, so the
    # full config is passed through then.
    hp_overridden = any(o.startswith("--hp.") for o in overrides)
    train_cfg = cfg if (args.config or hp_overridden) else None
    rng = np.random.default_rng(cfg.seed)
    fileset = PointCloudsInFiles(
        cfg.data.train_dir, cfg.data.glob, max_points=hi,
        use_columns=cfg.data.use_columns, filter_height=cfg.hp.ground_filter_height,
        dataset=cfg.data.use_datasets, biomass_csv=cfg.data.biomass_csv,
    )
    pos_list, feat_list, ys, ids = [], [], [], []
    for i in range(len(fileset)):
        item = fileset.get(i, rng)
        if item:
            pos_list.append(item[0])
            feat_list.append(item[1])
            ys.append(item[2])
            ids.append(item[3])
    point_density_effect(
        pos_list, feat_list, np.stack(ys), ids,
        point_range=range(lo, hi, step), out_csv=args.out_csv,
        cfg=train_cfg, num_epochs=cfg.num_epochs, seed=cfg.seed, device=device,
    )
    print(f"wrote {args.out_csv}")


def cmd_visualize_aug(argv):
    p = argparse.ArgumentParser(prog="visualize-aug")
    p.add_argument("--las", required=True)
    p.add_argument("--out", default="augmentation_vis.png")
    p.add_argument("--seed", type=int, default=0)
    _device_flag(p)
    args = p.parse_args(argv)

    from dl_biomass_tpu_torch.experiments.visualize_augmentation import visualize_augmentation
    from dl_biomass_tpu_torch.io.reader import read_las

    coords = read_las(args.las, get_attributes=False, filter_height=0)
    coords = coords - coords.mean(axis=0)
    aug = visualize_augmentation(coords, out_path=args.out, seed=args.seed, device=args.device)
    print(f"augmented {len(coords)} -> {len(aug)} points"
          + (f"; wrote {args.out}" if os.path.exists(args.out) else ""))


def cmd_parity_record(argv):
    p = argparse.ArgumentParser(prog="parity-record")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--biomass-csv", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--model-dir", default=None,
                   help="checkpoint dir; omit for a deterministic seed init")
    p.add_argument("--num-points", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    _device_flag(p)
    args = p.parse_args(argv)

    from dl_biomass_tpu_torch.eval.recorded import record_parity

    rec = record_parity(args.data_dir, args.biomass_csv, args.out,
                        model_dir=args.model_dir, num_points=args.num_points,
                        seed=args.seed, device=args.device)
    print(f"recorded {len(rec['predictions'])} plots -> {args.out}")


def cmd_parity_check(argv):
    p = argparse.ArgumentParser(prog="parity-check")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--biomass-csv", required=True)
    p.add_argument("--recorded", required=True)
    p.add_argument("--model-dir", default=None)
    p.add_argument("--rtol", type=float, default=None)
    _device_flag(p)
    args = p.parse_args(argv)

    from dl_biomass_tpu_torch.eval.recorded import DEFAULT_RTOL, check_parity

    d = check_parity(args.data_dir, args.biomass_csv, args.recorded,
                     model_dir=args.model_dir, rtol=args.rtol or DEFAULT_RTOL,
                     device=args.device)
    print(f"parity OK: max relative delta {d:.2e}")


def cmd_seed_study(argv):
    p = argparse.ArgumentParser(prog="seed-study")
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--modes", default="production,production+fast_fps,parity")
    p.add_argument("--num-plots", type=int, default=288)
    p.add_argument("--num-points", type=int, default=4096)
    p.add_argument("--max-epochs", type=int, default=40)
    # the study's training config; the defaults are run_seed_study's
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-augs", type=int, default=3)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--patience", type=int, default=8)
    p.add_argument("--neuron-multiplier", type=int, default=0,
                   help="SA/head width multiplier (reference constructor "
                        "knob; 0 = original architecture)")
    p.add_argument("--out", default="seed_study.json")
    _device_flag(p)
    args = p.parse_args(argv)

    from dl_biomass_tpu_torch.experiments.seed_study import run_seed_study

    run_seed_study(
        list(range(args.seeds)), args.modes.split(","),
        num_plots=args.num_plots, n_points=args.num_points,
        batch_size=args.batch_size, num_augs=args.num_augs,
        lr=args.lr, patience=args.patience,
        neuron_multiplier=args.neuron_multiplier,
        max_epochs=args.max_epochs, out_json=args.out, device=args.device,
    )
    print(f"wrote {args.out}")


COMMANDS = {
    "train": cmd_train,
    "seed-study": cmd_seed_study,
    "evaluate": cmd_evaluate,
    "predict": cmd_predict,
    "export-model": cmd_export_model,
    "resample": cmd_resample,
    "sweep": cmd_sweep,
    "tune": cmd_tune,
    "density": cmd_density,
    "visualize-aug": cmd_visualize_aug,
    "parity-record": cmd_parity_record,
    "parity-check": cmd_parity_check,
}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv[0]
    if cmd in UNPORTED:
        print(f"{cmd}: not ported to dl_biomass_tpu_torch yet: ROADMAP {UNPORTED[cmd]}")
        return 2
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; options: {', '.join(COMMANDS)}")
        return 2
    COMMANDS[cmd](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
