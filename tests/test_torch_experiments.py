"""The port's experiments and utilities against the JAX package's, on the CPU.

- ``experiments/density.py``: the subsampled clouds, the split and the
  ablation's default hyperparameters equal to JAX's for the same seed (both
  packages' training stubbed); a real run at toy size writes the CSV.
- ``experiments/seed_study.py``: ``_mode_config`` equal field by field, the
  voxel-grid modes among them; a real run's schema, and a voxel mode's run.
- ``experiments/visualize_augmentation.py``: the augmented cloud, the figure,
  and one line in its place without matplotlib.
- ``train/lr_finder.py``: the schedule, smoothing, stops and suggestion of
  ``lr_range_test`` against JAX's on scripted loss sequences (both packages'
  steps stubbed); a real run at toy size.
- ``utils/profiling.py``: ``StepTimer``, ``hard_sync`` and ``trace``.
"""

import copy
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import dl_biomass_tpu.io.device_data as jax_device_data
import dl_biomass_tpu.models.pointnet2 as jax_pointnet2
import dl_biomass_tpu.train.trainer as jax_trainer
import dl_biomass_tpu_torch.io.device_data as port_device_data
import dl_biomass_tpu_torch.models.pointnet2 as port_pointnet2
import dl_biomass_tpu_torch.train.trainer as port_trainer
from dl_biomass_tpu.core.config import TrainConfig as JaxConfig
from dl_biomass_tpu.experiments import density as jax_density
from dl_biomass_tpu.experiments import seed_study as jax_seed_study
from dl_biomass_tpu.io.synthetic import synthetic_plot
from dl_biomass_tpu.train import lr_finder as jax_lr_finder
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.experiments import density as port_density
from dl_biomass_tpu_torch.experiments import seed_study as port_seed_study
from dl_biomass_tpu_torch.experiments.visualize_augmentation import visualize_augmentation
from dl_biomass_tpu_torch.io.device_data import DeviceDataset
from dl_biomass_tpu_torch.io.synthetic import synthetic_dataset
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor
from dl_biomass_tpu_torch.train import lr_finder as port_lr_finder
from dl_biomass_tpu_torch.utils.profiling import StepTimer, hard_sync, trace

torch.set_num_threads(1)


def plots(n_plots, n_points, seed=0):
    rng = np.random.default_rng(seed)
    pos_list, feat_list = [], []
    for _ in range(n_plots):
        coords, intensity, _ = synthetic_plot(rng, n_points)
        pos_list.append((coords - coords.mean(0)).astype(np.float32))
        feat_list.append(intensity[:, None].astype(np.float32))
    y = rng.uniform(1, 50, size=(n_plots, 4)).astype(np.float32)
    return pos_list, feat_list, y, [f"RM_{i:03d}" for i in range(n_plots)]


# ---- density --------------------------------------------------------------------------


def stub_density_training(monkeypatch, device_data, pointnet2, build_name, trainer_mod):
    """Record every ``from_clouds`` call and each run's config; no training."""
    packed, configs = [], []

    class Packed:
        num_features = 1

        def batches(self, *args, **kwargs):
            yield None

    class Data:
        @classmethod
        def from_clouds(cls, pos_list, feat_list, y, ids, **kwargs):
            packed.append((pos_list, feat_list, np.asarray(y), list(ids), kwargs.get("base_n"),
                           kwargs.get("for_augmentation", True)))
            return Packed()

    class Fit:
        def __init__(self, model, cfg, *args, **kwargs):
            configs.append(cfg)

        def init_state(self, *args):
            return None

        def fit(self, *args, **kwargs):
            return {"best_val_mse": 1.0, "clouds_per_sec": [1.0], "epoch": [0]}

    monkeypatch.setattr(device_data, "DeviceDataset", Data)
    monkeypatch.setattr(pointnet2, build_name, lambda *a, **k: None)
    monkeypatch.setattr(trainer_mod, "Trainer", Fit)
    return packed, configs


@pytest.mark.parametrize("seed", [0, 5])
def test_density_subsamples_the_jax_packages_clouds(seed, monkeypatch):
    pos_list, feat_list, y, ids = plots(5, 300, seed=1)
    kw = dict(point_range=[100, 200, 400], num_epochs=3, seed=seed, log_fn=lambda s: None)
    jax_packed, jax_cfgs = stub_density_training(monkeypatch, jax_device_data, jax_pointnet2,
                                                 "build_model", jax_trainer)
    jax_df = jax_density.point_density_effect(pos_list, feat_list, y, ids, **kw)
    port_packed, port_cfgs = stub_density_training(monkeypatch, port_device_data,
                                                   port_pointnet2, "build_model",
                                                   port_trainer)
    port_df = port_density.point_density_effect(pos_list, feat_list, y, ids, device="cpu", **kw)
    assert len(port_packed) == len(jax_packed) == 6  # train and val, for each density
    for (pp, pf, py, pi, pn, pa), (jp, jf, jy, ji, jn, ja) in zip(port_packed, jax_packed):
        assert (pi, pn, pa) == (ji, jn, ja)
        np.testing.assert_array_equal(py, jy)
        for a, b in zip(pp + pf, jp + jf):
            np.testing.assert_array_equal(a, b)
    for pc, jc in zip(port_cfgs, jax_cfgs):  # the ablation's defaults; seed + point_num
        assert dataclasses.asdict(dataclasses.replace(pc, seed=0)) == dataclasses.asdict(jc)
    assert [c.seed for c in port_cfgs] == [seed + n for n in (100, 200, 400)]
    assert list(port_df.columns) == list(jax_df.columns) == [
        "point_num", "val_mse", "runtime", "clouds_per_sec", "epochs"]


def test_density_runs_and_writes_its_csv(tmp_path):
    pos_list, feat_list, y, ids = plots(4, 400)
    cfg = TrainConfig()
    cfg.hp.batch_size, cfg.hp.num_augs, cfg.num_epochs = 2, 1, 2
    out_csv = tmp_path / "density.csv"
    df = port_density.point_density_effect(pos_list, feat_list, y, ids, point_range=[100, 200],
                                           cfg=cfg, out_csv=str(out_csv), log_fn=lambda s: None,
                                           device="cpu")
    assert list(df["point_num"]) == [100, 200] and list(df["epochs"]) == [2, 2]
    assert np.isfinite(df[["val_mse", "runtime", "clouds_per_sec"]].to_numpy()).all()
    assert len(pd.read_csv(out_csv)) == 2


# ---- seed study -----------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["production", "production+fast_fps", "parity", "voxelnet",
                                  "voxelnet_deep", "voxelnet_wide48"])
def test_mode_config_is_the_jax_packages_field_by_field(mode):
    port_base, jax_base = TrainConfig(), JaxConfig()
    for base in (port_base, jax_base):
        base.hp.batch_size, base.num_epochs, base.model.fast_fps = 12, 3, False
    assert dataclasses.asdict(port_seed_study._mode_config(port_base, mode)) == \
        dataclasses.asdict(jax_seed_study._mode_config(jax_base, mode))


@pytest.mark.parametrize("mode,grid,channels", [("voxelnet", 32, (64, 128)),
                                                ("voxelnet_deep", 32, (64, 128, 256)),
                                                ("voxelnet_wide48", 48, (96, 192))])
def test_voxel_modes_build_the_voxel_model(mode, grid, channels):
    from dl_biomass_tpu_torch.models.voxelnet import VoxelNet

    model = port_pointnet2.build_model(port_seed_study._mode_config(TrainConfig(), mode), 1)
    assert isinstance(model, VoxelNet)
    assert (model.grid, model.channels, model.compute_dtype) == (grid, channels, torch.bfloat16)


def test_seed_study_runs_a_voxel_mode():
    res = port_seed_study.run_seed_study(
        [0], modes=("voxelnet",), num_plots=12, n_points=128, batch_size=4, num_augs=0,
        max_epochs=1, patience=2, log_fn=lambda s: None, device="cpu")
    (row,) = res["runs"]
    assert row["mode"] == "voxelnet" and row["epochs"] == 1
    assert np.isfinite(row["min_val_mse"]) and np.isfinite(row["r2_total"])


def test_an_unknown_mode_is_a_value_error():
    with pytest.raises(ValueError, match="unknown mode"):
        port_seed_study._mode_config(TrainConfig(), "fastest")


def test_seed_study_schema_and_summary(tmp_path):
    out = tmp_path / "study.json"
    res = port_seed_study.run_seed_study(
        [0, 1], modes=("production", "parity"), num_plots=12, n_points=128, batch_size=4,
        num_augs=0, max_epochs=1, patience=2, out_json=str(out), log_fn=lambda s: None,
        device="cpu")
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert [(r["mode"], r["seed"]) for r in res["runs"]] == [
        ("production", 0), ("production", 1), ("parity", 0), ("parity", 1)]
    for row in res["runs"]:
        assert row["epochs"] == 1 and np.isfinite(row["min_val_mse"])
        assert len(row["r2_components"]) == 4 and np.isfinite(row["r2_total"])
    for mode in ("production", "parity"):
        assert res["summary"][mode]["val_mse_sd"] >= 0.0
    assert res["runs"][0]["min_val_mse"] != res["runs"][1]["min_val_mse"]  # seeds differ
    again = port_seed_study.run_seed_study(
        [1], modes=("production",), num_plots=12, n_points=128, batch_size=4, num_augs=0,
        max_epochs=1, patience=2, log_fn=lambda s: None, device="cpu")
    assert again["runs"][0]["min_val_mse"] == res["runs"][1]["min_val_mse"]  # reproducible


# ---- augmentation figure ----------------------------------------------------------------


def test_visualize_augmentation_augments_and_draws(tmp_path):
    coords, _, _ = synthetic_plot(np.random.default_rng(0), 200)
    out = tmp_path / "aug.png"
    aug = visualize_augmentation(coords - coords.mean(0), out_path=str(out), device="cpu")
    assert out.stat().st_size > 5000
    assert 180 <= len(aug) <= 221 and np.isfinite(aug).all()
    again = visualize_augmentation(coords - coords.mean(0), device="cpu")
    np.testing.assert_array_equal(aug, again)  # seeded


def test_visualize_augmentation_without_matplotlib(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    coords, _, _ = synthetic_plot(np.random.default_rng(0), 200)
    out = tmp_path / "aug.png"
    aug = visualize_augmentation(coords, out_path=str(out), device="cpu")
    assert capsys.readouterr().out == f"matplotlib is not installed: {out} not written\n"
    assert not out.exists() and len(aug) >= 180


# ---- the LR range test --------------------------------------------------------------------


LOSS_SCRIPTS = {
    "falls_then_diverges": [10, 9, 7, 5, 3, 2, 1.5, 1.4, 2, 5, 40, 400, 4000, 4e4],
    "falls_throughout": list(np.linspace(10, 1, 14)),
    "nan_midway": [10, 8, 6, 4, float("nan"), 1, 1],
    "too_short_for_a_suggestion": [5, 4, float("inf")],
}


def jax_scripted(losses, num_iter, monkeypatch):
    it = iter(losses)

    class Model:
        def init(self, rngs, example, train):
            return {"params": {"w": jnp.zeros(2)}}

    def jit(step):
        def scripted(params, bstats, opt_state, batch, lr, k):
            return params, bstats, opt_state, jnp.float32(next(it))
        return scripted

    monkeypatch.setattr(jax, "jit", jit)
    try:
        return jax_lr_finder.lr_range_test(Model(), [None, None], key=jax.random.key(0),
                                           start_lr=1e-6, end_lr=1.0, num_iter=num_iter)
    finally:
        monkeypatch.undo()


def port_scripted(losses, num_iter, monkeypatch):
    it = iter(losses)
    monkeypatch.setattr(port_lr_finder, "_sgd_step",
                        lambda *a: torch.tensor(next(it), dtype=torch.float32))
    batch = CloudBatch(pos=torch.zeros(1, 4, 3), feat=torch.zeros(1, 4, 1),
                       mask=torch.ones(1, 4, dtype=torch.bool), y=torch.zeros(1, 4))
    return port_lr_finder.lr_range_test(torch.nn.Linear(2, 2), [batch, batch], start_lr=1e-6,
                                        end_lr=1.0, num_iter=num_iter, device="cpu")


@pytest.mark.parametrize("name", sorted(LOSS_SCRIPTS))
def test_lr_range_test_is_the_jax_packages_on_scripted_losses(name, monkeypatch):
    losses = LOSS_SCRIPTS[name]
    want = jax_scripted(losses, len(losses), monkeypatch)
    got = port_scripted(losses, len(losses), monkeypatch)
    assert got == want


def test_lr_range_test_runs_and_suggests():
    pos, feat, y, ids = synthetic_dataset(8, 128, seed=0)
    ds = DeviceDataset.from_clouds(pos, feat, y, ids, base_n=128, device="cpu")
    model = PointNet2Regressor(num_features=1)
    before = copy.deepcopy(model.state_dict())
    out = port_lr_finder.lr_range_test(model, ds.batches(4), start_lr=1e-6, end_lr=1.0,
                                       num_iter=12, device="cpu")
    assert len(out["lr"]) == len(out["loss"]) > 3
    assert out["lr"][0] == 1e-6 and out["lr"][0] < out["lr"][-1]
    assert np.isfinite(out["loss"]).all()
    assert out["suggestion"] is None or 1e-6 <= out["suggestion"] <= 1.0
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())  # untouched


# ---- profiling -----------------------------------------------------------------------------


def test_step_timer_and_hard_sync():
    t = StepTimer()
    x = torch.ones(8, 8)
    for _ in range(3):
        t.start()
        y = x * 2
        t.stop(sync_on={"y": y})
    s = t.summary(items_per_step=4)
    assert s["steps"] == 3 and s["items_per_sec"] > 0
    assert s["p50_ms"] <= s["p95_ms"]
    hard_sync([None, (x,)])  # no card: nothing to wait for
    hard_sync("no tensor")


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
