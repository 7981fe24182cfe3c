"""The port's command line (``python -m dl_biomass_tpu_torch``) on the CPU:
``resample`` (kernel 1's plain version, ``--engine cuda --device cpu``) ->
``train`` (2 epochs) -> ``evaluate`` -> ``predict`` (the engine, ``--no-engine``,
``--watch``) on a tiny raw corpus, through ``main`` as a user runs it; then
the research subcommands on the same corpus (``sweep``, ``tune`` and
``--continue-study``, ``density``, ``seed-study``, ``visualize-aug``,
``parity-record`` and ``parity-check``), also with scikit-learn or matplotlib
hidden; ``export-model`` then ``predict --from-export``; ``train`` with a
config mesh in one process; ``train`` -> ``evaluate`` -> ``predict`` of a
voxel model; every subcommand of the JAX CLI ported; and the refusals without
a card."""

import contextlib
import io
import json
import os
import shutil
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch

from dl_biomass_tpu_torch.__main__ import UNPORTED, main
from dl_biomass_tpu_torch.eval import predict
from dl_biomass_tpu_torch.models.pointnet2 import model_from_dict, model_to_dict
from dl_biomass_tpu_torch.tools.make_corpus import make_corpus
from dl_biomass_tpu_torch.utils.tboard import read_scalars
from torch_port_helpers import rel_err

torch.set_num_threads(1)

RAW, POINTS, SUFFIX = 600, 300, "_fps_300"
SPLITS = (("train", 8 / 12), ("val", 2 / 12), ("test", 2 / 12))
# the folded engine vs the unfolded module, both bf16 (chip_smoke.py's bound)
FOLDED_VS_MODULE_RTOL = 5e-2


def run(*argv) -> str:
    """``main(argv)`` in this process; its standard output. Fails on a
    non-zero return."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    assert rc == 0, out.getvalue()
    return out.getvalue()


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The disk path end to end in a fresh directory (the TensorBoard run
    directory lands under it)."""
    root = tmp_path_factory.mktemp("cli")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            make_corpus("raw", 12, RAW, seed=2, splits=SPLITS)
        logs = {}  # each run's output: the three resample splits, fit, evaluate, the predicts
        for split in ("train", "val", "test"):
            logs[split] = run("resample", "--in-dir", f"raw/{split}", "--out-dir", f"fps/{split}",
                              "--num-points", str(POINTS), "--format", "las", "--engine", "cuda",
                              "--device", "cpu")
        cfg = {"hp": {"batch_size": 4, "num_augs": 1, "num_points": POINTS},
               "data": {"train_dir": "fps/train", "val_dir": "fps/val",
                        "biomass_csv": "raw/biomass.csv", "presampled_suffix": SUFFIX},
               "model_dir": "models", "seed": 0}
        Path("cfg.json").write_text(json.dumps(cfg))
        logs["fit"] = run("train", "--config", "cfg.json", "--num_epochs", "2", "--tensorboard",
                            "--device", "cpu")
        logs["evaluate"] = run("evaluate", "--config", "cfg.json", "--model-dir", "models",
                               "--data.test_dir", "fps/test", "--fig-out-dir", "figs",
                               "--device", "cpu")
        common = ("--model-dir", "models", "--presampled-suffix", SUFFIX, "--batch-size", "4",
                  "--plot-bucket", "4", "--device", "cpu")
        logs["predict"] = run("predict", "--in-dir", "fps/test", "--out", "engine.csv", *common)
        logs["no_engine"] = run("predict", "--in-dir", "fps/test", "--out", "module.csv",
                                "--no-engine", *common)
        os.mkdir("arrivals")
        first, second = sorted(Path("fps/test").glob("*.las"))
        shutil.copy(first, "arrivals")

        def arrive(_seconds):
            shutil.copy(second, "arrivals")

        with mock.patch.object(predict.time, "sleep", side_effect=arrive):
            logs["watch"] = run("predict", "--in-dir", "arrivals", "--out", "watch.csv",
                                "--watch", "--max-polls", "2", "--poll-seconds", "0", *common)
    finally:
        os.chdir(cwd)
    return root, logs


def test_resample_wrote_every_plot_through_the_cuda_engine(pipeline):
    root, logs = pipeline
    for split, n in (("train", 8), ("val", 2), ("test", 2)):
        files = sorted((root / "fps" / split).glob("*.las"))
        assert len(files) == n and all(f.name.endswith(f"{SUFFIX}.las") for f in files)
        assert f"wrote {n} files" in logs[split]


def test_train_wrote_its_log_checkpoint_sidecar_and_curves(pipeline):
    root, logs = pipeline
    log = pd.read_csv(root / "models" / "training_log.csv", header=None)
    assert log.shape == (2, 3) and np.isfinite(log.to_numpy()).all()
    assert list(log[0]) == [0, 1]
    assert sorted(p.name for p in (root / "models").glob("epoch_*.pt"))
    sidecar = json.loads((root / "models" / "model_config.json").read_text())
    assert sidecar["train"]["hp"]["num_augs"] == 1 and sidecar["train"]["num_epochs"] == 2
    assert model_to_dict(model_from_dict(sidecar["model"])) == sidecar["model"]
    assert (root / "models" / "mse_curves.png").stat().st_size > 0
    assert "8 train / 2 val plots" in logs["fit"] and "Device: cpu" in logs["fit"]


def test_train_is_reproducible_from_the_config_seed(pipeline, monkeypatch):
    """The initial weights, the order, the augmentation and the steps all
    come from cfg.seed: a second run writes the same log."""
    root, _ = pipeline
    monkeypatch.chdir(root)
    run("train", "--config", "cfg.json", "--num_epochs", "2", "--model_dir", "again",
        "--device", "cpu")
    assert (root / "again" / "training_log.csv").read_text() == (
        root / "models" / "training_log.csv").read_text()


def test_train_wrote_the_tensorboard_scalars(pipeline):
    root, _ = pipeline
    events = list((root / "runs").rglob("events.out.tfevents.*"))
    assert len(events) == 1
    assert events[0].parent.name.endswith(f"_{POINTS}_pts_lr_0.00179966410046844")
    log = pd.read_csv(root / "models" / "training_log.csv", header=None,
                      float_precision="round_trip").to_numpy()
    scalars = read_scalars(str(events[0]))
    assert [(s, t) for s, t, _ in scalars] == [(0, "Training MSE"), (0, "Validation MSE"),
                                               (1, "Training MSE"), (1, "Validation MSE")]
    np.testing.assert_array_equal(np.asarray([v for _, _, v in scalars], np.float32),
                                  log[:, 1:].reshape(-1).astype(np.float32))


def test_evaluate_wrote_metrics_and_figures(pipeline):
    root, logs = pipeline
    assert "Using model:" in logs["evaluate"] and "tree_btphr" in logs["evaluate"]
    assert sorted(p.name for p in (root / "figs").iterdir()) == [
        "component_obs_vs_pred.png", "component_residuals.png", "tree_btphr_obs_vs_pred.png",
        "tree_btphr_residuals.png"]


def test_predict_wrote_the_engine_and_module_rows(pipeline):
    root, _ = pipeline
    engine = pd.read_csv(root / "engine.csv", index_col="PlotID")
    module = pd.read_csv(root / "module.csv", index_col="PlotID")
    assert list(engine.index) == list(module.index) == ["PF_0011", "RM_0010"]
    assert list(engine.columns) == ["bark_btphr", "branch_btphr", "foliage_btphr", "wood_btphr",
                                    "tree_btphr"]
    assert np.isfinite(engine.to_numpy()).all()
    assert rel_err(module.to_numpy(), engine.to_numpy()) <= FOLDED_VS_MODULE_RTOL
    direct = predict.predict_directory(str(root / "models"), str(root / "fps" / "test"),
                                       batch_size=4, presampled_suffix=SUFFIX, plot_bucket=4,
                                       device="cpu")
    np.testing.assert_array_equal(engine.to_numpy(np.float32), direct.to_numpy(np.float32))


def test_predict_watch_appended_the_plot_that_arrived(pipeline):
    root, logs = pipeline
    rows = pd.read_csv(root / "watch.csv", index_col="PlotID")
    engine = pd.read_csv(root / "engine.csv", index_col="PlotID")
    assert sorted(rows.index) == sorted(engine.index) and len(rows) == 2
    np.testing.assert_array_equal(rows.loc[engine.index].to_numpy(np.float32)[:, :4],
                                  engine.to_numpy(np.float32)[:, :4])
    assert "watch ended: 2 plots predicted" in logs["watch"]


FIX = Path(__file__).resolve().parent / "data" / "parity_fixture"
# the research subcommands on the pipeline's corpus, each a run of main()
RESEARCH = {
    "sweep": ["sweep", "--config", "cfg.json", "--lrs", "1e-4,1e-3", "--wds", "0",
              "--batch-sizes", "4", "--num-epochs", "2", "--study-out", "studies/sweep.json"],
    "tune": ["tune", "--config", "cfg.json", "--n-trials", "1", "--max-epochs", "1",
             "--study-out", "tune/tune.json"],
    "tune --continue-study": ["tune", "--config", "cfg.json", "--n-trials", "1",
                              "--max-epochs", "1", "--study-out", "tune/tune.json",
                              "--continue-study"],
    "density": ["density", "--data.train_dir", "raw/train", "--data.biomass_csv",
                "raw/biomass.csv", "--range", "100:201:100", "--num_epochs", "1",
                "--out-csv", "density.csv"],
    "seed-study": ["seed-study", "--seeds", "2", "--modes", "production,parity", "--num-plots",
                   "12", "--num-points", "128", "--max-epochs", "1", "--batch-size", "4",
                   "--num-augs", "0", "--out", "seed_study.json"],
    "visualize-aug": ["visualize-aug", "--las", "raw/test/PF_0011.las", "--out", "vis.png"],
    "parity-record": ["parity-record", "--data-dir", str(FIX), "--biomass-csv",
                      str(FIX / "biomass.csv"), "--out", "rec.json"],
    "parity-check": ["parity-check", "--data-dir", str(FIX), "--biomass-csv",
                     str(FIX / "biomass.csv"), "--recorded", "rec.json"],
}


@pytest.fixture(scope="module")
def research(pipeline):
    """Every research subcommand, in order, in the pipeline's directory."""
    root, _ = pipeline
    cwd = os.getcwd()
    os.chdir(root)
    try:
        logs = {name: run(*argv, "--device", "cpu") for name, argv in RESEARCH.items()}
    finally:
        os.chdir(cwd)
    return root, logs


def finite_values(study_json: Path) -> list:
    trials = json.loads(study_json.read_text())["trials"]
    assert all(np.isfinite(t["value"]) for t in trials)
    return trials


def check_sweep(root, log):
    trials = finite_values(root / "studies" / "sweep.json")
    assert [(t["params"]["lr"], t["params"]["batch_size"]) for t in trials] == [(1e-4, 4),
                                                                                 (1e-3, 4)]
    df = pd.read_csv(root / "studies" / "sweep_trials.csv")
    assert len(df) == 2 and {"value", "params_lr", "params_weight_decay"} <= set(df.columns)
    assert "2 trials in turn on each batch @ batch_size=4" in log and "Best trial" in log


def check_tune(root, log):
    assert "Best trial:" in log and "Param importances:" in log
    assert (root / "tune" / "tune_param_importances.png").stat().st_size > 0


def check_tune_continue_study(root, log):
    assert "Continuing study:" in log and "(1 trials)" in log
    trials = finite_values(root / "tune" / "tune.json")
    assert [t["number"] for t in trials] == [0, 1]
    assert len(pd.read_csv(root / "tune" / "tune_trials.csv")) == 2


def check_density(root, log):
    df = pd.read_csv(root / "density.csv")
    assert list(df["point_num"]) == [100, 200] and np.isfinite(df["val_mse"]).all()
    assert "wrote density.csv" in log


def check_seed_study(root, log):
    res = json.loads((root / "seed_study.json").read_text())
    assert [(r["mode"], r["seed"]) for r in res["runs"]] == [
        ("production", 0), ("production", 1), ("parity", 0), ("parity", 1)]
    assert all(np.isfinite(r["min_val_mse"]) for r in res["runs"])


def check_visualize_aug(root, log):
    assert (root / "vis.png").stat().st_size > 5000 and "wrote vis.png" in log


def check_parity_record(root, log):
    rec = json.loads((root / "rec.json").read_text())
    assert len(rec["predictions"]) == 6 and rec["framework"] == "torch"
    assert "recorded 6 plots" in log


def check_parity_check(root, log):
    assert "parity OK: max relative delta 0.00e+00" in log


CHECKS = {"sweep": check_sweep, "tune": check_tune,
          "tune --continue-study": check_tune_continue_study, "density": check_density,
          "seed-study": check_seed_study, "visualize-aug": check_visualize_aug,
          "parity-record": check_parity_record, "parity-check": check_parity_check}


@pytest.mark.parametrize("name", list(RESEARCH))
def test_research_subcommand_runs_end_to_end(research, name):
    root, logs = research
    CHECKS[name](root, logs[name])


def test_tune_without_scikit_learn_skips_the_importances(research, monkeypatch):
    root, _ = research
    monkeypatch.chdir(root)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    out = run("tune", "--config", "cfg.json", "--n-trials", "1", "--max-epochs", "1",
              "--study-out", "nosk/tune.json", "--device", "cpu")
    assert "scikit-learn is not installed: parameter importances and their figure skipped" in out
    assert "Param importances" not in out and not (root / "nosk" /
                                                   "tune_param_importances.png").exists()
    assert len(finite_values(root / "nosk" / "tune.json")) == 1
    assert (root / "nosk" / "tune_trials.csv").exists()


def test_without_matplotlib_no_figure_is_written(research, monkeypatch):
    root, _ = research
    monkeypatch.chdir(root)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = run("tune", "--config", "cfg.json", "--n-trials", "1", "--max-epochs", "1",
              "--study-out", "nomp/tune.json", "--device", "cpu")
    png = "nomp/tune_param_importances.png"
    assert f"matplotlib is not installed: {png} not written" in out and "Param importances" in out
    assert not (root / png).exists()
    out = run("visualize-aug", "--las", "raw/test/PF_0011.las", "--out", "nomp/vis.png",
              "--device", "cpu")
    assert "matplotlib is not installed: nomp/vis.png not written" in out
    assert not (root / "nomp" / "vis.png").exists()


def test_every_subcommand_of_the_jax_cli_is_ported():
    from dl_biomass_tpu.__main__ import COMMANDS as JAX_COMMANDS
    from dl_biomass_tpu_torch.__main__ import COMMANDS

    assert UNPORTED == {} and set(JAX_COMMANDS) <= set(COMMANDS)


def test_export_model_then_predict_from_export(pipeline, monkeypatch):
    """The deployment loop: checkpoint -> ``export-model --device cpu`` (the
    points rounded up to the 128-point capacity) -> ``predict --from-export``,
    whose rows are the engine's (``engine.csv``); ``--watch`` serves from the
    artifact too."""
    root, _ = pipeline
    monkeypatch.chdir(root)
    out = run("export-model", "--model-dir", "models", "--out", "art", "--batch-size", "4",
              "--num-points", str(POINTS), "--device", "cpu")
    assert "wrote artifact -> art (platforms ['cpu'], envelope 4x384x1)" in out
    meta = json.loads((root / "art" / "meta.json").read_text())
    assert meta["num_points"] == 384 and meta["platforms"] == ["cpu"]
    common = ("--presampled-suffix", SUFFIX, "--from-export", "art", "--device", "cpu")
    out = run("predict", "--in-dir", "fps/test", "--out", "export.csv", "--model-dir", "none",
              *common)
    assert "Using exported artifact: art" in out
    engine = pd.read_csv(root / "engine.csv", index_col="PlotID")
    exported = pd.read_csv(root / "export.csv", index_col="PlotID")
    assert list(exported.index) == list(engine.index)
    np.testing.assert_allclose(exported.to_numpy(), engine.to_numpy(), rtol=1e-6, atol=1e-6)
    run("predict", "--in-dir", "fps/test", "--out", "watch_export.csv", "--watch",
        "--max-polls", "1", "--poll-seconds", "0", *common)
    watched = pd.read_csv(root / "watch_export.csv", index_col="PlotID")
    np.testing.assert_allclose(watched.loc[engine.index].to_numpy(), engine.to_numpy(),
                               rtol=1e-6, atol=1e-6)


def test_train_evaluate_predict_a_voxel_model(pipeline, monkeypatch):
    """``train --model.family voxelnet`` on the same corpus writes a voxel
    sidecar; ``evaluate`` rebuilds the model from it, and ``predict`` serves
    it through the module (the folded engine covers PointNet2Regressor only),
    its rows those of ``--no-engine``."""
    from dl_biomass_tpu_torch.models.voxelnet import VoxelNet

    root, _ = pipeline
    monkeypatch.chdir(root)
    run("train", "--config", "cfg.json", "--num_epochs", "2", "--model.family", "voxelnet",
        "--model.voxel_grid", "8", "--model_dir", "vox", "--device", "cpu")
    sidecar = json.loads((root / "vox" / "model_config.json").read_text())["model"]
    assert sidecar["family"] == "voxelnet" and sidecar["grid"] == 8
    assert isinstance(model_from_dict(sidecar), VoxelNet)
    assert len((root / "vox" / "training_log.csv").read_text().splitlines()) == 2
    out = run("evaluate", "--config", "cfg.json", "--model-dir", "vox", "--data.test_dir",
              "fps/test", "--fig-out-dir", "vox_figs", "--device", "cpu")
    assert "tree_btphr" in out
    common = ("--model-dir", "vox", "--presampled-suffix", SUFFIX, "--batch-size", "4",
              "--plot-bucket", "4", "--device", "cpu")
    run("predict", "--in-dir", "fps/test", "--out", "vox.csv", *common)
    run("predict", "--in-dir", "fps/test", "--out", "vox_module.csv", "--no-engine", *common)
    served = pd.read_csv(root / "vox.csv", index_col="PlotID")
    assert list(served.index) == ["PF_0011", "RM_0010"] and np.isfinite(served.to_numpy()).all()
    np.testing.assert_array_equal(
        served.to_numpy(), pd.read_csv(root / "vox_module.csv", index_col="PlotID").to_numpy())


def test_help_and_an_unknown_command(capsys):
    assert main(["--help"]) == 0 and "python -m dl_biomass_tpu_torch train" in (
        capsys.readouterr().out)
    assert main(["fly"]) == 2 and "unknown command" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["train", "--config", "cfg.json"],
    ["evaluate", "--config", "cfg.json", "--model-dir", "models", "--data.test_dir", "fps/test"],
    ["resample", "--in-dir", "raw/test", "--out-dir", "again", "--engine", "numpy"],
    ["predict", "--model-dir", "models", "--in-dir", "fps/test", "--out", "x.csv"],
    ["export-model", "--model-dir", "models", "--out", "art_card"],
    ["predict", "--from-export", "art_card", "--in-dir", "fps/test", "--out", "x.csv"],
    *[RESEARCH[name] for name in ("sweep", "tune", "density", "seed-study", "visualize-aug",
                                  "parity-record")],
    ["parity-check", "--data-dir", str(FIX), "--biomass-csv", str(FIX / "biomass.csv"),
     "--recorded", str(FIX / "recorded.json"), "--model-dir", "models"],
])
def test_every_subcommand_needs_a_card_or_device_cpu(pipeline, argv, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(pipeline[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_train_in_one_process_leaves_the_config_mesh_aside(pipeline, monkeypatch):
    """Outside ``torchrun`` (one process) a config's mesh is not used, as the
    JAX CLI uses none over one device: the same log as without it."""
    root, _ = pipeline
    monkeypatch.chdir(root)
    run("train", "--config", "cfg.json", "--num_epochs", "2", "--model_dir", "mesh1",
        "--mesh.dp", "2", "--device", "cpu")
    assert (root / "mesh1" / "training_log.csv").read_text() == (
        root / "models" / "training_log.csv").read_text()
