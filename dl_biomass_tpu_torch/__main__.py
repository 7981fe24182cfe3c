"""Command-line interface of the PyTorch port (port of ``dl_biomass_tpu/__main__.py``).

    python -m dl_biomass_tpu_torch resample --in-dir ... --out-dir ... --method fps --engine cuda
    python -m dl_biomass_tpu_torch train    --config cfg.json [--hp.lr 1e-3 ...]
    python -m dl_biomass_tpu_torch evaluate --config cfg.json --model-dir ...
    python -m dl_biomass_tpu_torch predict  --model-dir ... --in-dir ... --out preds.csv

Any config knob is overridable with dotted flags (``--hp.batch_size 16``) or
top-level TrainConfig fields (``--num_epochs 2``). Every subcommand runs on
the card; ``--device cpu`` runs the kernels' plain versions on the CPU
instead. Without a card and without that flag, they raise.

Not ported yet (each exits with code 2 and names its ROADMAP item): sweep,
tune, density, seed-study, visualize-aug, export-model, parity-record and
parity-check.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List

from dl_biomass_tpu_torch.core.config import TrainConfig

_TOP_LEVEL_KEYS = {f.name for f in dataclasses.fields(TrainConfig)}

# the subcommands of the JAX CLI that wait for a module of the port
UNPORTED = {
    "sweep": "A.6 (sweeps)",
    "tune": "A.6 (sweeps)",
    "density": "A.7 (experiments)",
    "seed-study": "A.7 (experiments)",
    "visualize-aug": "A.7 (experiments)",
    "export-model": "A.8 (parallelism and export)",
    "parity-record": "A.5 (eval/recorded.py)",
    "parity-check": "A.5 (eval/recorded.py)",
}


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
    if cfg.mesh.dp > 1 or cfg.mesh.mp > 1:
        raise NotImplementedError(
            f"training on more than one device (mesh dp={cfg.mesh.dp}, mp={cfg.mesh.mp}) is "
            "not ported yet: ROADMAP A.8")

    import torch

    from dl_biomass_tpu_torch.core.cloud import resolve_device
    from dl_biomass_tpu_torch.eval.testing import figure_module
    from dl_biomass_tpu_torch.models.pointnet2 import build_model
    from dl_biomass_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    print(f"Dataset(s): {cfg.data.use_datasets}")
    print(f"Additional features used: {cfg.data.use_columns}")
    print(f"Using {cfg.hp.num_points} points per plot")
    print(f"Early stopping: {cfg.early_stopping}")
    print(f"Max number of epochs: {cfg.num_epochs}")
    print(f"Device: {device}")
    print("\nHyperparameters:")
    for k, v in vars(cfg.hp).items():
        print(f"  {k}: {v}")

    ds_train, ds_val = _load_train_val(cfg, device)
    print(f"\n{len(ds_train)} train / {len(ds_val)} val plots "
          f"({1 + cfg.hp.num_augs}x train samples with augmentation)")

    torch.manual_seed(cfg.seed)  # the initial weights, as the JAX CLI draws them from cfg.seed
    model = build_model(cfg, num_features=ds_train.num_features)
    trainer = Trainer(model, cfg, device)

    writer = None
    if args.tensorboard:
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
                   help="serve through an exported artifact (not ported yet: ROADMAP A.8)")
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


COMMANDS = {
    "train": cmd_train,
    "evaluate": cmd_evaluate,
    "predict": cmd_predict,
    "resample": cmd_resample,
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
