"""The port's evaluation path (``dl_biomass_tpu_torch/eval/``:
``metrics``, ``testing``, ``predict``; ``models/pointnet2.model_from_dict``)
against the JAX package's, on the CPU. Metrics and frames are compared
exactly; predictions on weights moved from flax (``bridge.from_flax_variables``)
within the serving tolerance of ``tests/test_torch_inference.py`` (float32
1e-4, bf16 1e-2 of max|y|)."""

import json
import shutil
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch

from dl_biomass_tpu.eval import metrics as jax_metrics
from dl_biomass_tpu.eval import predict as jax_predict
from dl_biomass_tpu.eval import testing as jax_testing
from dl_biomass_tpu.io import dataset as jax_dataset
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.eval import metrics, predict, testing
from dl_biomass_tpu_torch.io import dataset, resample
from dl_biomass_tpu_torch.models.pointnet2 import (PointNet2Regressor, build_model,
                                                   model_from_dict, model_to_dict)
from dl_biomass_tpu_torch.tools.make_corpus import make_corpus
from dl_biomass_tpu_torch.train import checkpoint
from torch_port_helpers import BF16_RTOL, F32_RTOL, batches, models, rel_err

torch.set_num_threads(1)

N_POINTS, SUFFIX = 512, "_fps_512"


@pytest.fixture(scope="module")
def plots(tmp_path_factory):
    """Five presampled test plots of 512 points (numpy FPS over 640) and the
    biomass table."""
    root = tmp_path_factory.mktemp("eval")
    make_corpus(str(root / "raw"), 5, 640, seed=8, splits=(("test", 1.0),))
    resample.resample_point_clouds(str(root / "raw" / "test"), str(root / "fps"), N_POINTS,
                                   samp_meth="fps", use_parquet=False, engine="numpy",
                                   log_fn=lambda _: None, device="cpu")
    return root


def _datasets(plots):
    kw = dict(dataset=("BC", "RM", "PF"), biomass_csv=str(plots / "raw" / "biomass.csv"),
              presampled_suffix=SUFFIX)
    return (dataset.PointCloudsInFilesPreSampled(str(plots / "fps"), "*.las", **kw).load_all(
                for_augmentation=False, device="cpu"),
            jax_dataset.PointCloudsInFilesPreSampled(str(plots / "fps"), "*.las", **kw).load_all(
                for_augmentation=False))


def _bridged(preset, dtype):
    jb, _ = batches(1, 2, N_POINTS, [N_POINTS, 400])
    return models(preset, dtype, jb)


def _checkpoint(model_dir, tm):
    """A port checkpoint of ``tm`` with its sidecar, as ``Trainer.fit`` writes them."""
    checkpoint.save_checkpoint(str(model_dir), tm, torch.optim.Adam(tm.parameters()), epoch=3,
                               val_mse=1.5)
    with open(model_dir / "model_config.json", "w") as f:
        json.dump({"model": model_to_dict(tm), "train": TrainConfig().to_dict()}, f)


def test_metrics_table_and_results_frame_equal_jax():
    rng = np.random.default_rng(0)
    obs = rng.uniform(1, 50, (9, 4)).astype(np.float32)
    pred = (obs + rng.normal(size=(9, 4))).astype(np.float32)
    ids = [f"{p}_{i:04d}" for i, p in enumerate(["BC", "RM", "PF"] * 3)]
    got = metrics.build_results_frame(obs, pred, ids)
    want = jax_metrics.build_results_frame(obs, pred, ids)
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(metrics.metrics_table(got), jax_metrics.metrics_table(want))
    assert metrics.r2_score(obs[:, 0], obs[:, 0]) == 1.0


@pytest.mark.parametrize("overrides", [
    {},
    {"compute_dtype": "float32", "exact_selection": True, "fast_group": False,
     "fast_fps": False},
    {"doubled_radius": True, "neuron_multiplier": 2, "activation_function": "ELU"},
    {"fused_sa": True, "split_first_layer": False, "dropout_probability": 0.2},
])
def test_model_from_dict_rebuilds_the_model(overrides):
    """``model_from_dict(model_to_dict(m))`` has m's constructor arguments and
    takes m's ``state_dict`` strictly."""
    cfg = TrainConfig()
    for k, v in overrides.items():
        setattr(cfg.hp if hasattr(cfg.hp, k) else cfg.model, k, v)
    m = build_model(cfg, num_features=1)
    d = model_to_dict(m)
    rebuilt = model_from_dict(json.loads(json.dumps(d)))
    assert isinstance(rebuilt, PointNet2Regressor) and model_to_dict(rebuilt) == d
    rebuilt.load_state_dict(m.state_dict())
    assert rebuilt.sa1_radius == m.sa1_radius and rebuilt.compute_dtype == m.compute_dtype


@pytest.mark.parametrize("variant", [
    {}, {"msg": True}, {"remat": True}, {"analytic_bn": True},
    {"num_outputs": 3}, {"num_outputs": 1, "global_width_mult": 2},
])
def test_the_sidecar_has_the_jax_names(variant):
    """The port's sidecar is JAX's ``model_to_dict`` of the same model less its
    kernel switch ``use_pallas``, for every variant; it rebuilds the model,
    which takes the original's ``state_dict``."""
    from dl_biomass_tpu.models.pointnet2 import PointNet2Regressor as JaxModel
    from dl_biomass_tpu.models.pointnet2 import model_to_dict as jax_model_to_dict

    jd = jax_model_to_dict(JaxModel(num_features=1, fast_group=True, fast_fps=True, **variant))
    m = PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True, **variant)
    d = model_to_dict(m)
    assert d == {k: v for k, v in jd.items() if k != "use_pallas"}
    rebuilt = model_from_dict(json.loads(json.dumps(d)))
    assert model_to_dict(rebuilt) == d
    rebuilt.load_state_dict(m.state_dict())


@pytest.mark.parametrize("kwargs", [dict(num_features=1, grid=12, extent=10.0),
                                    dict(num_features=2, channels=(64, 128, 256),
                                         compute_dtype="bfloat16")])
def test_the_voxel_sidecar_has_the_jax_names(kwargs):
    """A voxel model's sidecar (``family="voxelnet"``) is the JAX package's and
    rebuilds the model in either package."""
    import jax.numpy as jnp

    from dl_biomass_tpu.models.pointnet2 import model_from_dict as jax_model_from_dict
    from dl_biomass_tpu.models.pointnet2 import model_to_dict as jax_model_to_dict
    from dl_biomass_tpu.models.voxelnet import VoxelNet as JaxVoxelNet
    from dl_biomass_tpu_torch.models.voxelnet import VoxelNet

    dt = kwargs.pop("compute_dtype", "float32")
    m = VoxelNet(**kwargs, compute_dtype=getattr(torch, dt))
    d = model_to_dict(m)
    assert d == jax_model_to_dict(JaxVoxelNet(**kwargs, compute_dtype=getattr(jnp, dt)))
    rebuilt = model_from_dict(json.loads(json.dumps(d)))
    assert isinstance(rebuilt, VoxelNet) and model_to_dict(rebuilt) == d
    rebuilt.load_state_dict(m.state_dict())
    assert jax_model_to_dict(jax_model_from_dict(json.loads(json.dumps(d)))) == d


def test_load_model_for_eval_rebuilds_a_voxel_model_also_in_parity(tmp_path):
    """A voxel checkpoint loads through its sidecar; ``parity`` runs it in
    float32 (it has no selection to make exact)."""
    from dl_biomass_tpu_torch.models.voxelnet import VoxelNet

    vm = VoxelNet(num_features=1, grid=8, compute_dtype=torch.bfloat16)
    _checkpoint(tmp_path, vm)
    for parity, dtype in ((False, torch.bfloat16), (True, torch.float32)):
        model, _ = testing.load_model_for_eval(str(tmp_path), parity=parity, device="cpu")
        assert isinstance(model, VoxelNet) and model.compute_dtype == dtype
        for k, v in vm.state_dict().items():
            assert torch.equal(model.state_dict()[k], v), k


def test_an_unknown_family_is_a_value_error():
    with pytest.raises(ValueError, match="unknown model family"):
        model_from_dict({"family": "pointnet3", "num_features": 1})


@pytest.mark.parametrize("parity", [False, True])
def test_load_model_for_eval_rebuilds_the_newest_checkpoint(tmp_path, parity):
    _, _, tm = _bridged("production", "bfloat16")
    _checkpoint(tmp_path, tm)
    checkpoint.save_checkpoint(str(tmp_path), tm, torch.optim.Adam(tm.parameters()), epoch=1,
                               val_mse=2.0)  # older
    model, path = testing.load_model_for_eval(str(tmp_path), parity=parity, device="cpu")
    assert path.endswith("epoch_00003.pt") and not model.training
    for k, v in tm.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    want = TrainConfig().apply_parity().model if parity else TrainConfig().model
    assert (model.compute_dtype == torch.float32) == (want.compute_dtype == "float32")
    assert (model.fast_group, model.fast_fps, model.exact_selection) == (
        want.fast_group, want.fast_fps, want.exact_selection)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        testing.load_model_for_eval(str(tmp_path / "none"), device="cpu")


@pytest.mark.parametrize("preset,dtype,rtol", [("production", "bfloat16", BF16_RTOL),
                                               ("parity", "float32", F32_RTOL)])
def test_predict_dataset_matches_jax(plots, preset, dtype, rtol):
    """The eval-mode module over the presampled plots, in plot order, against
    JAX's ``predict_dataset`` on the bridged weights."""
    tds, jds = _datasets(plots)
    jm, v, tm = _bridged(preset, dtype)
    got = testing.predict_dataset(tm, tds, batch_size=2)
    want = np.asarray(jax_testing.predict_dataset(jm, v["params"], v["batch_stats"], jds, 2))
    assert got.shape == want.shape == (5, 4) and got.dtype == np.float32
    assert rel_err(got, want) <= rtol
    np.testing.assert_array_equal(testing.predict_dataset(tm, tds, batch_size=2), got)


@pytest.fixture(scope="module")
def served(plots, tmp_path_factory):
    """The production bf16 model's checkpoint, and both packages'
    ``predict_directory`` over the plots with the engine and without it."""
    model_dir = tmp_path_factory.mktemp("model")
    jm, v, tm = _bridged("production", "bfloat16")
    _checkpoint(model_dir, tm)
    loaded = (jm, v["params"], v["batch_stats"], "bridged")
    out = {}
    for engine in (True, False):
        kw = dict(use_datasets=None, batch_size=2, presampled_suffix=SUFFIX, engine=engine,
                  plot_bucket=4)
        out["port", engine] = predict.predict_directory(
            str(model_dir), str(plots / "fps"), str(model_dir / f"p{engine}.csv"),
            device="cpu", **kw)
        with mock.patch.object(jax_testing, "load_model_for_eval", return_value=loaded):
            out["jax", engine] = jax_predict.predict_directory(
                "unused", str(plots / "fps"), None, **kw)
    return model_dir, out


@pytest.mark.parametrize("engine", [True, False])
def test_predict_directory_matches_jax(served, engine):
    model_dir, out = served
    got, want = out["port", engine], out["jax", engine]
    assert list(got.index) == list(want.index) == ["BC_0000", "BC_0003", "PF_0002", "RM_0001",
                                                   "RM_0004"]
    assert list(got.columns) == list(want.columns)
    assert rel_err(got.to_numpy(), want.to_numpy()) <= BF16_RTOL
    csv = pd.read_csv(model_dir / f"p{engine}.csv", index_col="PlotID")
    np.testing.assert_array_equal(csv.to_numpy(np.float32), got.to_numpy(np.float32))


# the folded engine vs the unfolded module, both bf16: folding BatchNorm into the
# weights moves where each layer rounds to bf16 (chip_smoke.py's bound, 5e-2)
FOLDED_VS_MODULE_RTOL = 5e-2


def test_predict_directory_engine_and_module_agree(served):
    """The folded engine against the eval-mode module on the same weights."""
    _, out = served
    assert rel_err(out["port", True].to_numpy(),
                   out["port", False].to_numpy()) <= FOLDED_VS_MODULE_RTOL


def test_predict_directory_refuses_an_export_and_an_empty_directory(served, tmp_path):
    model_dir, _ = served
    with pytest.raises(FileNotFoundError, match="meta.json"):  # no artifact at the path
        predict.predict_directory(str(model_dir), str(tmp_path), export_path=str(tmp_path / "x"),
                                  device="cpu")
    with pytest.raises(FileNotFoundError, match="no \\*.las plots"):
        predict.predict_directory(str(model_dir), str(tmp_path), device="cpu")


def test_watch_directory_appends_a_plot_added_between_polls(served, plots, tmp_path):
    """Two polls; the fifth plot arrives between them. The rows equal
    ``predict_directory``'s bit for bit (one bucket of 4 plots a batch)."""
    model_dir, out = served
    files = sorted((plots / "fps").glob("*.las"))
    watch = tmp_path / "in"
    watch.mkdir()
    for f in files[:4]:
        shutil.copy(f, watch)

    def arrive(_seconds):
        shutil.copy(files[4], watch)

    csv = tmp_path / "watch.csv"
    with mock.patch.object(predict.time, "sleep", side_effect=arrive) as slept:
        n = predict.watch_directory(str(model_dir), str(watch), str(csv), max_polls=2,
                                    batch_size=4, presampled_suffix=SUFFIX, plot_bucket=4,
                                    log_fn=lambda _: None, device="cpu")
    assert n == 5 and slept.call_count == 1
    rows = pd.read_csv(csv, index_col="PlotID")
    direct = predict.predict_directory(str(model_dir), str(plots / "fps"), batch_size=4,
                                       presampled_suffix=SUFFIX, plot_bucket=4, device="cpu")
    assert list(rows.index) == ["BC_0000", "BC_0003", "PF_0002", "RM_0001", "RM_0004"]
    np.testing.assert_array_equal(rows.loc[direct.index].to_numpy(np.float32)[:, :4],
                                  direct.to_numpy(np.float32)[:, :4])
    again = predict.watch_directory(str(model_dir), str(watch), str(csv), max_polls=1,
                                    presampled_suffix=SUFFIX, log_fn=lambda _: None,
                                    device="cpu")
    assert again == 0 and len(pd.read_csv(csv)) == 5


def test_test_model_writes_metrics_and_figures(served, plots, tmp_path):
    """``test_model`` against JAX's on the same weights: obs exactly, the
    predictions within the serving tolerance; the four figure families."""
    model_dir, _ = served
    jm, v, _ = _bridged("production", "bfloat16")
    kw = dict(test_dataset_path=str(plots / "fps"), biomass_csv=str(plots / "raw" / "biomass.csv"),
              presampled_suffix=SUFFIX, batch_size=2)
    mdf, df = testing.test_model(model_dir=str(model_dir), fig_out_dir=str(tmp_path / "p"),
                                 device="cpu", **kw)
    with mock.patch.object(jax_testing, "load_model_for_eval",
                           return_value=(jm, v["params"], v["batch_stats"], "bridged")):
        _, jdf = jax_testing.test_model(fig_out_dir=str(tmp_path / "j"), **kw)
    obs = [c for c in df.columns if c.endswith("_obs")]
    pred = [c for c in df.columns if c.endswith("_pred")]
    pd.testing.assert_frame_equal(df[obs], jdf[obs])
    assert rel_err(df[pred].to_numpy(), jdf[pred].to_numpy()) <= BF16_RTOL
    assert list(mdf.index) == list(metrics.ALL_ROWS) and np.isfinite(
        mdf.to_numpy(np.float64)).all()
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())


def test_test_model_without_matplotlib_writes_no_figures(served, plots, tmp_path, capsys):
    """Where matplotlib is not installed the evaluation still runs, writes no
    figure and says so."""
    model_dir, _ = served
    real = testing.importlib.util.find_spec
    with mock.patch.object(testing.importlib.util, "find_spec",
                           lambda name, *a: None if name == "matplotlib" else real(name, *a)):
        mdf, _ = testing.test_model(
            model_dir=str(model_dir), test_dataset_path=str(plots / "fps"),
            biomass_csv=str(plots / "raw" / "biomass.csv"), presampled_suffix=SUFFIX,
            fig_out_dir=str(tmp_path / "figs"), device="cpu")
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert not (tmp_path / "figs").exists() and len(mdf) == 5
