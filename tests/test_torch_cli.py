"""The port's command line (``python -m dl_biomass_tpu_torch``) on the CPU:
``resample`` (kernel 1's plain version, ``--engine cuda --device cpu``) ->
``train`` (2 epochs) -> ``evaluate`` -> ``predict`` (the engine, ``--no-engine``,
``--watch``) on a tiny raw corpus, through ``main`` as a user runs it; the
unported subcommands; and the refusals without a card."""

import contextlib
import io
import json
import os
import shutil
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


@pytest.mark.parametrize("cmd", sorted(UNPORTED))
def test_unported_subcommands_exit_2_naming_their_roadmap_item(cmd, capsys):
    assert main([cmd, "--anything"]) == 2
    out = capsys.readouterr().out
    assert cmd in out and f"ROADMAP {UNPORTED[cmd].split()[0]}" in out


def test_help_and_an_unknown_command(capsys):
    assert main(["--help"]) == 0 and "python -m dl_biomass_tpu_torch train" in (
        capsys.readouterr().out)
    assert main(["fly"]) == 2 and "unknown command" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["train", "--config", "cfg.json"],
    ["evaluate", "--config", "cfg.json", "--model-dir", "models", "--data.test_dir", "fps/test"],
    ["resample", "--in-dir", "raw/test", "--out-dir", "again", "--engine", "numpy"],
    ["predict", "--model-dir", "models", "--in-dir", "fps/test", "--out", "x.csv"],
])
def test_every_subcommand_needs_a_card_or_device_cpu(pipeline, argv, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(pipeline[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_train_refuses_a_mesh(pipeline, monkeypatch):
    monkeypatch.chdir(pipeline[0])
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        main(["train", "--config", "cfg.json", "--mesh.dp", "2", "--device", "cpu"])
