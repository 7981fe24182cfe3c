"""The port's recorded-fixture parity pathway (``eval/recorded.py``) on the CPU.

The JAX package froze its LAS-bytes -> prediction pipeline in parity mode on
``tests/data/parity_fixture`` (6 plots, 512 points, batch 8, f32, its seed-0
init) as ``recorded.json``. Here the port replays that recording with JAX's
seed-0 parity init carried across (``bridge.from_flax_variables``, saved as a
port checkpoint), within ``DEFAULT_RTOL``; the measured delta is asserted
well under it. A perturbed recording fails, a recording of JAX's init without
its parameters is refused, and a recording the port makes replays to 5e-4,
as ``tests/test_recorded_parity.py`` holds the JAX package.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dl_biomass_tpu.eval import recorded as jax_recorded
from dl_biomass_tpu_torch.bridge import from_flax_variables
from dl_biomass_tpu_torch.eval.recorded import (DEFAULT_RTOL, FRAMEWORK, check_parity,
                                                record_parity)
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor, model_to_dict
from dl_biomass_tpu_torch.train.checkpoint import save_checkpoint

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "data", "parity_fixture")
CSV = os.path.join(FIX, "biomass.csv")
REC = os.path.join(FIX, "recorded.json")
# the cross-framework replay: both pipelines are f32 with the same draws and
# selections, so only the order of f32 sums differs (measured 3.1e-7)
CROSS_FRAMEWORK_BOUND = 1e-3
ROUND_TRIP_BOUND = 5e-4  # tests/test_recorded_parity.py's bound on a replay


@pytest.fixture(scope="module")
def jax_init_dir(tmp_path_factory):
    """JAX's seed-0 parity init, as its ``_parity_model`` builds it, as a port
    checkpoint with its ``model_config.json``."""
    _, params, batch_stats = jax_recorded._parity_model(1, None, 0)
    variables = jax.tree.map(np.asarray, {"params": params, "batch_stats": batch_stats})
    model = PointNet2Regressor(num_features=1, compute_dtype=torch.float32,
                               exact_selection=True)
    model.load_state_dict(from_flax_variables(variables))
    d = tmp_path_factory.mktemp("jax_init")
    save_checkpoint(str(d), model, torch.optim.Adam(model.parameters()), epoch=0, val_mse=0.0)
    (d / "model_config.json").write_text(json.dumps({"model": model_to_dict(model)}))
    return str(d)


def test_the_port_replays_the_committed_jax_recording(jax_init_dir):
    delta = check_parity(FIX, CSV, REC, model_dir=jax_init_dir, device="cpu")
    assert delta <= DEFAULT_RTOL
    assert delta < CROSS_FRAMEWORK_BOUND


def test_a_perturbed_recording_fails(jax_init_dir, tmp_path):
    with open(REC) as f:
        rec = json.load(f)
    pid = sorted(rec["predictions"])[0]
    rec["predictions"][pid][0] += 0.05  # way past rtol on these predictions
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(rec))
    with pytest.raises(AssertionError, match="drifted"):
        check_parity(FIX, CSV, str(bad), model_dir=jax_init_dir, device="cpu")


def test_a_changed_plot_set_fails(jax_init_dir, tmp_path):
    with open(REC) as f:
        rec = json.load(f)
    rec["predictions"].pop(sorted(rec["predictions"])[0])
    bad = tmp_path / "fewer.json"
    bad.write_text(json.dumps(rec))
    with pytest.raises(AssertionError, match="plot set changed"):
        check_parity(FIX, CSV, str(bad), model_dir=jax_init_dir, device="cpu")


def test_a_jax_seed_init_recording_needs_its_parameters():
    """The port's own init differs from JAX's: replaying JAX's seed-init
    recording from the port's seed init would be a false drift, so it is
    refused with the way out named."""
    with pytest.raises(ValueError, match="--model-dir"):
        check_parity(FIX, CSV, REC, device="cpu")


def test_record_and_check_round_trip(tmp_path):
    out = tmp_path / "rec.json"
    rec = record_parity(FIX, CSV, str(out), num_points=256, seed=3, device="cpu")
    assert len(rec["predictions"]) == 6
    assert all(np.isfinite(v).all() for v in map(np.asarray, rec["predictions"].values()))
    assert rec["framework"] == FRAMEWORK and rec["backend"] == "cpu"
    assert rec["params"] == "seed-3 init" and rec["num_points"] == 256
    assert check_parity(FIX, CSV, str(out), device="cpu") < ROUND_TRIP_BOUND


def test_a_checkpoint_recording_replays_from_the_checkpoint(jax_init_dir, tmp_path):
    """Recorded from the carried-over JAX init: the same predictions as the
    JAX recording's, and a replay of it from that checkpoint."""
    out = tmp_path / "ckpt.json"
    rec = record_parity(FIX, CSV, str(out), model_dir=jax_init_dir, device="cpu")
    assert rec["params"] == "checkpoint"
    with open(REC) as f:
        want = json.load(f)
    assert rec["targets"] == want["targets"]
    for pid, row in want["predictions"].items():
        np.testing.assert_allclose(rec["predictions"][pid], row, rtol=0,
                                   atol=CROSS_FRAMEWORK_BOUND * np.abs(row).max())
    assert check_parity(FIX, CSV, str(out), model_dir=jax_init_dir, device="cpu") == 0.0


def test_the_recording_needs_a_card_or_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        record_parity(FIX, CSV, str(tmp_path / "r.json"))
