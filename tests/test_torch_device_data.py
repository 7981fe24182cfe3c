"""The port's on-device dataset (``dl_biomass_tpu_torch/io/device_data.py``),
the trainer's epochs over it and ``compile_dataset_inference``, on the CPU,
against the JAX package's ``DeviceDataset``, ``Trainer.train_epoch_fused`` and
``compile_dataset_inference`` on the same clouds and bridged weights. The
augmentation draws are JAX's own, handed to the port (``jax_batch_draws``);
FPS starts at each cloud's first valid point in both packages, and dropout is
0, where whole epochs are compared."""

import copy
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.core.config import TrainConfig as JaxTrainConfig
from dl_biomass_tpu.io import device_data as jax_device_data
from dl_biomass_tpu.models.inference import (
    compile_dataset_inference as jax_compile_dataset_inference)
from dl_biomass_tpu.ops import fps as jax_fps
from dl_biomass_tpu.train.trainer import Trainer as JaxTrainer
from dl_biomass_tpu.train.trainer import TrainState
from dl_biomass_tpu_torch.bridge import to_flax_variables
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.io.device_data import DeviceDataset, _assemble_batch
from dl_biomass_tpu_torch.models.inference import compile_dataset_inference
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor
from dl_biomass_tpu_torch.ops import fps
from dl_biomass_tpu_torch.train.trainer import Trainer
from test_torch_augment import jax_batch_draws
from test_torch_step import flat, torch_name, zero_gradient
from torch_port_helpers import BF16_RTOL, F32_RTOL, batches, models, rel_err

torch.set_num_threads(1)


def plot_clouds(p, n, f=1, seed=0, lo=None):
    """p host clouds of lo..n points (numpy), their targets and ids."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo or n // 2, n + 1, size=p)
    pos = [(rng.normal(size=(k, 3)) * 3).astype(np.float32) for k in sizes]
    feat = [rng.normal(size=(k, f)).astype(np.float32) for k in sizes]
    y = (rng.normal(size=(p, 4)) * 3).astype(np.float32)
    return pos, feat, y, [f"P{i:03d}" for i in range(p)]


def both(p, n, f=1, seed=0, base_n=None, for_augmentation=True, lo=None):
    clouds = plot_clouds(p, n, f, seed, lo)
    jds = jax_device_data.DeviceDataset.from_clouds(*clouds, base_n=base_n,
                                                    for_augmentation=for_augmentation)
    tds = DeviceDataset.from_clouds(*clouds, base_n=base_n, for_augmentation=for_augmentation,
                                    device="cpu")
    return jds, tds


def _same_arrays(tds, jds):
    for name in ("pos", "feat", "mask", "y"):
        np.testing.assert_array_equal(getattr(tds, name).numpy(),
                                      np.asarray(getattr(jds, name)), err_msg=name)
    assert tds.plot_ids == jds.plot_ids and tds.base_n == jds.base_n


@pytest.mark.parametrize("for_augmentation,base_n", [(True, None), (False, None), (True, 200)])
def test_from_clouds_and_pad_plots_equal_jax(for_augmentation, base_n):
    """The packed tensors (capacity aug_capacity(base_n) or base_n rounded to
    128; clouds beyond base_n cut), and the plot axis zero-padded with
    ``__pad__`` ids, exactly as the JAX package packs them."""
    jds, tds = both(5, 300, f=2, seed=1, base_n=base_n, for_augmentation=for_augmentation)
    _same_arrays(tds, jds)
    _same_arrays(tds.pad_plots(8), jds.pad_plots(8))
    assert tds.pad_plots(5) is tds and len(tds.pad_plots(8)) == 8
    with pytest.raises(ValueError, match="pad_plots"):
        tds.pad_plots(4)


def _order(jds, num_augs, seed):
    """JAX's epoch order under one key, to hand to both datasets."""
    return jds.epoch_order(jax.random.key(seed), num_augs, True)


@pytest.mark.parametrize("batch_size,num_augs", [(4, 2), (5, 0), (7, 1)])
def test_epoch_specs_equal_jax_given_the_same_order(batch_size, num_augs):
    """``epoch_spec_arrays`` and ``epoch_specs``: the chunks, flags, pads and
    offsets JAX gives for the same epoch order (the partial last batch padded
    with invalid samples); the port's augmentation seed derives from the
    offset as JAX's key does."""
    jds, tds = both(6, 200, seed=2)
    order = _order(jds, num_augs, 3)
    with mock.patch.object(jax_device_data.DeviceDataset, "epoch_order", lambda *a: order), \
            mock.patch.object(DeviceDataset, "epoch_order", lambda *a: order):
        want = jds.epoch_spec_arrays(batch_size, key=jax.random.key(0), num_augs=num_augs,
                                     shuffle=True)
        got = tds.epoch_spec_arrays(batch_size, seed=0, num_augs=num_augs, shuffle=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        specs = list(tds.epoch_specs(batch_size, seed=0, num_augs=num_augs, shuffle=True))
        jspecs = list(jds.epoch_specs(batch_size, key=jax.random.key(0), num_augs=num_augs,
                                      shuffle=True))
    assert len(specs) == len(jspecs) == -(-6 * (1 + num_augs) // batch_size)
    for (i, a, v, s), (ji, ja, jv, _), b0 in zip(specs, jspecs, want[3]):
        for g, w in ((i, ji), (a, ja), (v, jv)):
            np.testing.assert_array_equal(g, w)
        assert s == tds.aug_seed(0, int(b0))
    assert len({s for *_, s in specs}) == len(specs)


def test_epoch_order_is_the_reference_concat_and_repeats_under_a_seed():
    _, tds = both(4, 100)
    idx, aug = tds.epoch_order(None, 2, False)
    assert idx.tolist() == [0, 1, 2, 3] * 3 and aug.tolist() == [False] * 4 + [True] * 8
    a, b = tds.epoch_order(5, 2, True), tds.epoch_order(5, 2, True)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert sorted(a[0].tolist()) == sorted(idx.tolist())
    assert not np.array_equal(a[0], tds.epoch_order(6, 2, True)[0])
    with pytest.raises(ValueError, match="seed"):
        tds.epoch_spec_arrays(4, num_augs=1)


def test_assemble_batch_matches_jax_on_its_draws():
    """Gathered clouds, pad samples masked out, augmented ones where flagged:
    the mask exactly, positions and features to 1e-6 (the rotation)."""
    jds, tds = both(5, 300, seed=4)
    idx = np.array([3, 0, 3, 1, 0, 0], np.int32)
    flag = np.array([True, False, True, True, False, False])
    valid = np.array([True, True, True, True, False, False])
    key = jax.random.key(9)
    want = jax_device_data._assemble_batch(jds.pos, jds.feat, jds.mask, jds.y, idx, flag, valid,
                                           key, base_n=jds.base_n)
    draws = jax_batch_draws(key, len(idx), tds.pos.shape[1], 1)
    got = _assemble_batch(tds.pos, tds.feat, tds.mask, tds.y, torch.from_numpy(idx).long(),
                          torch.from_numpy(flag), torch.from_numpy(valid), draws,
                          base_n=tds.base_n)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.feat.numpy(), np.asarray(want.feat), rtol=1e-6, atol=1e-6)
    assert not got.mask[4:].any()
    plain = _assemble_batch(tds.pos, tds.feat, tds.mask, tds.y, torch.from_numpy(idx).long(),
                            torch.zeros(6, dtype=torch.bool), torch.from_numpy(valid), None,
                            base_n=tds.base_n)
    assert torch.equal(plain.pos, tds.pos[idx]) and torch.equal(plain.mask[:4], tds.mask[idx[:4]])


# ---- the trainer's epochs -------------------------------------------------------------


def _small_model(**kw):
    torch.manual_seed(0)
    return PointNet2Regressor(num_features=1, fast_group=True, fast_fps=True, **kw)


def _cfg(**hp):
    cfg = TrainConfig()
    return dataclasses.replace(cfg, hp=dataclasses.replace(cfg.hp, **hp))


def test_scan_fused_and_batches_epochs_are_bit_identical():
    """``train_epoch_scan``, ``train_epoch_fused`` and ``train_epoch`` over
    ``ds.batches`` with ``step_generator(seed)``: the same losses and
    parameters bit for bit (shuffled, two augmented copies, a partial last
    batch); then ``evaluate_scan`` equals ``evaluate_fused``."""
    _, ds = both(5, 256, seed=5)
    model = _small_model()
    cfg = _cfg(batch_size=4, num_augs=2)
    runs = {}
    for name in ("scan", "fused", "batches"):
        tr = Trainer(copy.deepcopy(model), cfg, device="cpu")
        if name == "scan":
            out = tr.train_epoch_scan(ds, 11, batch_size=4, num_augs=2)
        elif name == "fused":
            out = tr.train_epoch_fused(ds, 11, batch_size=4, num_augs=2)
        else:
            out = tr.train_epoch(ds.batches(4, seed=11, num_augs=2, shuffle=True),
                                 tr.step_generator(11))
        runs[name] = out, tr.model.state_dict(), tr
    assert runs["scan"][0] == runs["fused"][0] == runs["batches"][0]
    assert runs["scan"][0][1] == 15
    for name in ("fused", "batches"):
        for k, v in runs["scan"][1].items():
            assert torch.equal(v, runs[name][1][k]), (name, k)
    tr = runs["scan"][2]
    assert tr.evaluate_scan(ds, batch_size=4) == tr.evaluate_fused(ds, batch_size=4) == \
        tr.evaluate(ds.batches(4))


def _first_valid_starts():
    """FPS starting at each cloud's first valid point in both packages."""
    return (mock.patch.object(fps, "random_starts", lambda mask, g: mask.int().argmax(1)),
            mock.patch.object(jax_fps, "_random_start",
                              lambda key, mask: jnp.argmax(mask, axis=-1).astype(jnp.int32)))


def test_fused_epoch_matches_jax_fused_epoch():
    """One ``train_epoch_fused`` epoch (8 plots of 300-640 points, B=8, no
    augmentation) against JAX's on bridged weights, float32 with ELU and
    dropout 0, FPS from the first valid point, under the step bounds of
    ``tests/test_torch_step.py``: the loss to 1e-5 (relative), the running
    statistics to 1e-4 of their largest, each parameter's move to 1e-3 x lr
    where its gradient's sign is sure, the biases whose true gradient is 0
    (Adam moves them by noise) by no more than lr. Over more steps Adam turns
    the ~1e-4 agreement of the gradients into moves of up to 2 lr on the
    elements whose gradient is near 0."""
    clouds = plot_clouds(8, 640, seed=6, lo=300)
    jds = jax_device_data.DeviceDataset.from_clouds(*clouds, base_n=640, for_augmentation=False)
    tds = DeviceDataset.from_clouds(*clouds, base_n=640, for_augmentation=False, device="cpu")
    jb, _ = batches(0, 8, 640, [640] * 8)
    jm, v, tm = models("production", "float32", jb, dropout_probability=0.0,
                       activation_function="ELU")
    jtr = JaxTrainer(jm, JaxTrainConfig())
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=jtr.tx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    port, jaxs = _first_valid_starts()
    jax.clear_caches()
    with port, jaxs:
        state, jloss, jn = jtr.train_epoch_fused(state, jds, jax.random.key(0), batch_size=8,
                                                 shuffle=False)
        tloss, tn = Trainer(tm, TrainConfig(), device="cpu").train_epoch_fused(
            tds, 0, batch_size=8, shuffle=False)
    jax.clear_caches()
    assert tn == jn == 8 and abs(tloss - jloss) <= 1e-5 * abs(jloss)
    tv = to_flax_variables(tm)
    lr = TrainConfig().hp.lr
    grads = {n: p.grad.double().numpy() for n, p in tm.named_parameters()}
    old, jnew, tnew = (dict(flat(t)) for t in (v["params"], state.params, tv["params"]))
    for path in old:
        dj, dt = jnew[path] - old[path], tnew[path] - old[path]
        if zero_gradient(torch_name(path)):
            assert max(np.abs(dj).max(), np.abs(dt).max()) <= lr * 1.001, path
            continue
        g = grads[torch_name(path)]
        g = g.T if path[-1] == "kernel" else g
        sure = np.abs(g) > 1e-3 * np.abs(g).max()
        assert np.abs(dt - dj)[sure].max() <= 1e-3 * lr, path
    for path, js in dict(flat(state.batch_stats)).items():
        assert np.abs(dict(flat(tv["batch_stats"]))[path] - js).max() <= 1e-4 * np.abs(js).max()


def test_fit_over_device_datasets_resumes_as_it_would_have_run(tmp_path):
    """``fit`` trains over a DeviceDataset (scan epochs, and fused with
    ``scan_epochs=False``, the same numbers) with augmentation; a run resumed
    after its first epoch draws the second epoch an uninterrupted run draws."""
    _, ds = both(6, 256, seed=7)
    logs = []
    hist = {}
    for scan in (True, False):
        cfg = dataclasses.replace(_cfg(batch_size=4, num_augs=1, patience=10), scan_epochs=scan)
        tr = Trainer(_small_model(), cfg, device="cpu")
        hist[scan] = tr.fit(ds, ds, num_epochs=2, log_fn=logs.append)
    assert hist[True]["train_mse"] == hist[False]["train_mse"]
    assert hist[True]["val_mse"] == hist[False]["val_mse"]
    assert len(hist[True]["epoch"]) == 2 and all(c > 0 for c in hist[True]["clouds_per_sec"])
    cfg = _cfg(batch_size=4, num_augs=1, patience=10)
    first = Trainer(_small_model(), cfg, device="cpu")
    first.fit(ds, ds, num_epochs=1, checkpoint_dir=str(tmp_path), log_fn=logs.append)
    resumed = Trainer(_small_model(), cfg, device="cpu")
    h = resumed.fit(ds, ds, num_epochs=2, checkpoint_dir=str(tmp_path), resume=True,
                    log_fn=logs.append)
    assert h["epoch"] == [1] and h["train_mse"] == hist[True]["train_mse"][1:]


def test_train_epoch_over_a_device_dataset_needs_a_seed_alone():
    _, ds = both(4, 128, seed=8)
    tr = Trainer(_small_model(), _cfg(batch_size=4, num_augs=0), device="cpu")
    with pytest.raises(ValueError, match="seed"):
        tr.train_epoch(ds)
    with pytest.raises(ValueError, match="seed"):
        tr.train_epoch(ds, torch.Generator(), seed=1)
    loss, n = tr.train_epoch(ds, seed=1)
    assert np.isfinite(loss) and n == 4


# ---- serving -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype,fused_eval,rtol", [("float32", False, F32_RTOL),
                                                   ("bfloat16", False, BF16_RTOL),
                                                   ("float32", True, F32_RTOL)])
def test_compile_dataset_inference_matches_jax(dtype, fused_eval, rtol):
    """Every plot's row, in ``plot_ids`` order, pad samples of the partial last
    batch dropped, against JAX's ``compile_dataset_inference`` on bridged
    weights (the engine tolerance of ``tests/test_torch_inference.py``); equal
    to the engine over ``ds.batches`` bit for bit."""
    jds, tds = both(5, 512, seed=9)
    jb, _ = batches(1, 2, 512, [512, 400])
    jm, v, tm = models("production", dtype, jb)
    want = np.asarray(jax_compile_dataset_inference(jm, v, fused_eval=fused_eval)(jds, 2))
    serve_ds = compile_dataset_inference(tm, "cpu", fused_eval=fused_eval)
    got = serve_ds(tds, 2)
    assert got.shape == want.shape == (5, 4) and got.dtype == np.float32
    assert rel_err(got, want) <= rtol
    from dl_biomass_tpu_torch.models.inference import compile_inference

    serve = compile_inference(tm, "cpu", fused_eval=fused_eval)
    rows = torch.cat([serve(b) for b in tds.batches(2)]).numpy()[:5]
    np.testing.assert_array_equal(got, rows)
