"""The port's training surface on the CPU: the train-mode forward (random FPS
starts, dropout, running statistics), ``Trainer`` (step, evaluate, predict,
fit with its CSV, save-on-best checkpoints and resume) and its device rule;
and SA2's branch beyond 4096 SA1 centroids against the JAX package."""

import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.models.pointnet2 import PointNet2Regressor as JaxModel
from dl_biomass_tpu.models.pointnet2 import SAModule as JaxSAModule
from dl_biomass_tpu.models.pointnet2 import model_to_dict as jax_model_to_dict
from dl_biomass_tpu_torch.bridge import from_flax_variables
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.io.synthetic import synthetic_dataset
from dl_biomass_tpu_torch.models.inference import compile_inference
from dl_biomass_tpu_torch.models.pointnet2 import (MXU_MAX_POINTS, PointNet2Regressor, SAModule,
                                                   build_model, model_to_dict)
from dl_biomass_tpu_torch.ops import gather_kernel
from dl_biomass_tpu_torch.train import checkpoint
from dl_biomass_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N = 384


def small_model(**kw):
    return PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True, **kw)


def synthetic_batches(num, b, seed):
    pos, feat, y, _ = synthetic_dataset(num, N, seed=seed)
    sizes = np.random.default_rng(seed).integers(N // 2, N + 1, size=num)
    pos = [p[:s] for p, s in zip(pos, sizes)]
    feat = [f[:s] for f, s in zip(feat, sizes)]
    return [CloudBatch.from_numpy(pos[i:i + b], feat[i:i + b], y[i:i + b], capacity=N,
                                  device="cpu") for i in range(0, num, b)]


def gen(seed):
    return torch.Generator().manual_seed(seed)


# ---- the train-mode forward ---------------------------------------------------------


def test_train_forward_repeats_under_a_seed_and_moves_running_statistics():
    batch = synthetic_batches(4, 4, 0)[0]
    model = small_model()
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    a = model(batch, train=True, generator=gen(1))
    moved = [k for k, v in model.state_dict().items() if "running" in k
             and not torch.equal(v, before[k])]
    assert len(moved) == len(before)  # every BatchNorm's mean and var
    model.load_state_dict(dict(model.state_dict(), **before))
    b = model(batch, train=True, generator=gen(1))
    c = model(batch, train=True, generator=gen(2))
    assert a.shape == (4, 4) and bool(torch.isfinite(a).all())
    assert torch.equal(a, b) and not torch.equal(a, c)  # FPS starts and dropout follow the seed


def test_train_forward_with_dropout_needs_a_generator():
    batch = synthetic_batches(2, 2, 1)[0]
    with pytest.raises(ValueError, match="generator"):
        small_model()(batch, train=True)
    out = small_model(dropout_probability=0.0)(batch, train=True)  # first-valid FPS starts
    assert bool(torch.isfinite(out).all())


def test_sa1_edges_carry_no_gradient_and_sa1_learns_through_the_gather():
    """SA1's kernel-2 edges are data; SA1's MLP gets its gradient only through
    SA2's gathered z-table (the scatter-add backward)."""
    batch = synthetic_batches(4, 4, 2)[0]
    model = small_model(dropout_probability=0.0, compute_dtype=torch.bfloat16)
    calls = []
    real = gather_kernel.scatter_rows

    def spy(ct, idx, n):
        calls.append(tuple(ct.shape))
        return real(ct, idx, n)

    with mock.patch.object(gather_kernel, "scatter_rows", spy):
        model(batch, train=True).square().sum().backward()
    assert calls == [(4, 20, 64, 128)]  # SA2: 20 centroids of the 77 SA1 ones
    assert float(model.sa1.mlp.lin0.weight.grad.abs().max()) > 0


# ---- Trainer ------------------------------------------------------------------------


def test_loss_falls_over_steps_on_a_fixed_batch():
    batch = synthetic_batches(4, 4, 3)[0]
    torch.manual_seed(0)  # the torch-default Linear init of this test's model
    trainer = Trainer(small_model(), TrainConfig(), device="cpu")
    g = gen(0)
    losses = [float(trainer.step(batch, g)) for _ in range(11)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_a_step_after_an_evaluation_in_a_fresh_process():
    """The loss caches its component weights per device; a first call from
    an evaluation (inference mode) must not leave a tensor that a training
    step cannot save for its backward."""
    code = ("import torch\n"
            "from dl_biomass_tpu_torch.train import loss\n"
            "with torch.inference_mode():\n"
            "    loss.weighted_component_mse(torch.zeros(2, 4), torch.ones(2, 4))\n"
            "p = torch.zeros(2, 4, requires_grad=True)\n"
            "loss.weighted_component_mse(p, torch.ones(2, 4)).backward()\n"
            "assert float(p.grad.abs().sum()) > 0\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_evaluate_and_predict_drop_pad_clouds():
    trainer = Trainer(small_model(), TrainConfig(), device="cpu")
    batches = synthetic_batches(5, 3, 4)
    pad = batches[-1]  # 2 clouds, and one all-pad cloud appended
    pad = CloudBatch(pos=torch.cat([pad.pos, torch.zeros(1, N, 3)]),
                     feat=torch.cat([pad.feat, torch.zeros(1, N, 1)]),
                     mask=torch.cat([pad.mask, torch.zeros(1, N, dtype=torch.bool)]),
                     y=torch.cat([pad.y, torch.zeros(1, 4)]))
    preds = trainer.predict(batches[:-1] + [pad])
    assert preds.shape == (5, 4) and np.isfinite(preds).all()
    assert np.array_equal(preds, trainer.predict(batches[:-1] + [pad]))
    assert np.isfinite(trainer.evaluate(batches))


def test_fit_writes_csv_saves_on_best_and_resumes(tmp_path):
    train, val = synthetic_batches(6, 3, 5), synthetic_batches(3, 3, 6)
    ckpt, csv = tmp_path / "ckpt", tmp_path / "log.csv"
    cfg = TrainConfig()
    cfg.early_stopping = False
    torch.manual_seed(0)
    trainer = Trainer(small_model(), cfg, device="cpu")
    logs = []
    hist = trainer.fit(lambda epoch: train, lambda: val, num_epochs=2, csv_path=str(csv),
                       checkpoint_dir=str(ckpt), log_fn=logs.append)
    assert hist["epoch"] == [0, 1] and all(np.isfinite(hist["train_mse"]))
    lines = csv.read_text().splitlines()
    assert [int(line.split(",")[0]) for line in lines] == [0, 1]
    assert float(lines[1].split(",")[2]) == hist["val_mse"][1]
    saved = [e for e in (0, 1) if (ckpt / f"epoch_{e:05d}.pt").exists()]
    best = int(np.argmin(hist["val_mse"]))
    assert best in saved and saved[-1] == max(saved)
    assert checkpoint.latest_checkpoint(str(ckpt)).endswith(f"epoch_{saved[-1]:05d}.pt")
    sidecar = json.loads((ckpt / "model_config.json").read_text())
    assert sidecar["model"] == model_to_dict(trainer.model)
    assert sidecar["train"]["hp"]["lr"] == cfg.hp.lr
    # resume: a fresh model picks up the saved weights and optimizer state
    fresh = Trainer(small_model(), cfg, device="cpu")
    meta = checkpoint.restore_latest(str(ckpt), fresh.model, fresh.optimizer)
    assert meta["epoch"] == saved[-1]
    resumed = Trainer(small_model(), cfg, device="cpu")
    hist2 = resumed.fit(lambda epoch: train, lambda: val, num_epochs=3, csv_path=str(csv),
                        checkpoint_dir=str(ckpt), log_fn=logs.append, resume=True)
    assert hist2["epoch"] == list(range(saved[-1] + 1, 3))
    assert any("Resuming from epoch" in line for line in logs)
    assert len(csv.read_text().splitlines()) == 2 + len(hist2["epoch"])


def test_checkpoint_round_trip(tmp_path):
    a = Trainer(small_model(), TrainConfig(), device="cpu")
    a.step(synthetic_batches(2, 2, 7)[0], gen(0))
    checkpoint.save_checkpoint(str(tmp_path), a.model, a.optimizer, epoch=3, val_mse=1.5)
    b = Trainer(small_model(), TrainConfig(), device="cpu")
    assert checkpoint.restore_latest(str(tmp_path), b.model, b.optimizer) == {"epoch": 3,
                                                                            "val_mse": 1.5}
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k])
    assert b.optimizer.state_dict()["state"][0]["step"] == 1
    assert checkpoint.restore_latest(str(tmp_path / "none"), b.model) is None


def test_trainer_device_rule_and_device_dataset():
    """No card: the trainer raises unless given the CPU. On the CPU ``fit``
    runs over a DeviceDataset, training and validation both on it."""
    import dataclasses

    from dl_biomass_tpu_torch.io.device_data import DeviceDataset

    model = small_model()
    with mock.patch("torch.cuda.is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(model, TrainConfig())
    cfg = TrainConfig()
    cfg = dataclasses.replace(cfg, hp=dataclasses.replace(cfg.hp, batch_size=2, num_augs=1))
    trainer = Trainer(model, cfg, device="cpu")
    pos, feat, y, ids = synthetic_dataset(3, N, seed=4)
    ds = DeviceDataset.from_clouds(pos, feat, y, ids, device="cpu")
    hist = trainer.fit(ds, ds, num_epochs=1, log_fn=lambda _: None)
    assert hist["epoch"] == [0] and np.isfinite(hist["train_mse"][0])
    assert np.isfinite(hist["val_mse"][0]) and hist["clouds_per_sec"][0] > 0


def test_model_to_dict_names_the_jax_constructor_arguments():
    ours = model_to_dict(build_model(TrainConfig(), num_features=1))
    ref = jax_model_to_dict(JaxModel(num_features=1, fast_group=True, fast_fps=True,
                                     compute_dtype=jnp.bfloat16))
    ref.pop("use_pallas")
    assert ours == ref


# ---- SA2 beyond 4096 SA1 centroids --------------------------------------------------


def _counting_gather():
    return mock.patch.object(gather_kernel, "gather_rows", wraps=gather_kernel.gather_rows)


@pytest.mark.parametrize("n,split", [(4224, False), (1024, True)])
def test_sa2_gathers_unsplit_beyond_4096_points_like_jax(n, split):
    """SA2 alone on N points of 128 features: above MXU_MAX_POINTS the JAX
    package gathers [h_j, p_j - c_i] per edge, at or below it gathers the
    per-point z-table; the port takes the same branch and matches at f32."""
    rng = np.random.default_rng(n)
    pos = (rng.normal(size=(1, n, 3)) * 4).astype(np.float32)
    feat = rng.normal(size=(1, n, 128)).astype(np.float32)
    mask = np.arange(n)[None] < n - 200
    args = jnp.asarray(feat), jnp.asarray(pos), jnp.asarray(mask)
    jsa = JaxSAModule(0.25, 8.0, [131, 128, 128, 256], use_pallas=True, fast_fps=True)
    v = jsa.init(jax.random.key(0), *args, train=False)
    want = [np.asarray(w) for w in jsa.apply(v, *args, train=False)]
    sa = SAModule(0.25, 8.0, [131, 128, 128, 256], fast_fps=True)
    sa.load_state_dict(from_flax_variables(jax.tree.map(np.asarray, v)))
    with torch.no_grad(), _counting_gather() as g:
        got = sa(torch.from_numpy(feat), torch.from_numpy(pos), torch.from_numpy(mask))
    assert (n > MXU_MAX_POINTS) != split and g.call_count == int(split)
    for a, b in zip(got, want):
        assert np.abs(a.numpy().astype(np.float64) - b).max() <= 1e-4 * np.abs(b).max()


def test_serving_engine_gathers_unsplit_beyond_4096_sa1_centroids():
    """One cloud of 20608 points: SA1 keeps 4122 centroids, so the engine, like
    the JAX engine, leaves the split path; it matches the module forward."""
    n = 20608
    rng = np.random.default_rng(1)
    batch = CloudBatch(pos=torch.from_numpy((rng.normal(size=(1, n, 3)) * 5).astype(np.float32)),
                       feat=torch.from_numpy(rng.normal(size=(1, n, 1)).astype(np.float32)),
                       mask=torch.ones(1, n, dtype=torch.bool))
    model = small_model()
    with _counting_gather() as g:
        out = compile_inference(model, device="cpu")(batch)
    assert g.call_count == 0
    with torch.no_grad():
        ref = model(batch)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
