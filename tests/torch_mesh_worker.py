"""The rank body of ``tests/test_torch_mesh.py``: one spawned 2-rank gloo group
on the CPU runs every check of the port's data parallelism and saves what
it saw to ``rank<r>.pt``; the test process holds those results against the
JAX package and against one process. Imports torch and the port only (a
spawned rank imports this module, never jax)."""

import contextlib
import hashlib
import io
import os
from unittest import mock

import torch

from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.core.config import HyperParams, TrainConfig
from dl_biomass_tpu_torch.io.device_data import DeviceDataset
from dl_biomass_tpu_torch.io.synthetic import synthetic_dataset
from dl_biomass_tpu_torch.models.inference import compile_dataset_inference, compile_inference
from dl_biomass_tpu_torch.models.layers import MaskedBatchNorm
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor
from dl_biomass_tpu_torch.parallel import mesh as dp
from dl_biomass_tpu_torch.sweep.vmapped import VmappedSweep
from dl_biomass_tpu_torch.train.trainer import Trainer

EPOCH_PLOTS, EPOCH_POINTS, EPOCH_BATCH, EPOCH_SEED = 8, 256, 4, 11
SWEEP_LRS, SWEEP_WDS = (1e-3, 3e-3), (0.0, 1e-4)


def _model(kwargs, state):
    model = PointNet2Regressor(**kwargs)
    model.load_state_dict(state)
    return model


def _batch(arrays):
    pos, feat, mask, y = (torch.from_numpy(a) for a in arrays)
    return CloudBatch(pos=pos, feat=feat, mask=mask, y=y)


def _step(kwargs, state, batch, mesh):
    """One ``Trainer.step`` without a generator (FPS from the first valid
    point, dropout 0): the loss, every gradient, the new state."""
    trainer = Trainer(_model(kwargs, state), TrainConfig(), device="cpu", mesh=mesh)
    loss = float(trainer.step(batch))
    grads = {n: p.grad.double().numpy().copy() for n, p in trainer.model.named_parameters()}
    new = {k: v.double().numpy().copy() for k, v in trainer.model.state_dict().items()}
    return dict(loss=loss, grads=grads, state=new)


def _stats_used(fn, parts: int = 1):
    """``fn()`` and, for each train-mode BatchNorm of it in forward order,
    the (mean, var) it used and a digest of its input's rows in ``parts``
    equal slices of the batch (a rank's rows are one slice of one
    process's)."""
    real, used = MaskedBatchNorm.batch_stats, []

    def record(xf, mask):
        mean, var, cnt = real(xf, mask)
        digests = [hashlib.sha1(x.detach().contiguous().numpy().tobytes()).hexdigest()
                   for x in xf.chunk(parts, dim=0)]
        used.append((mean.detach().numpy().copy(), var.detach().numpy().copy(), digests))
        return mean, var, cnt

    with mock.patch.object(MaskedBatchNorm, "batch_stats", staticmethod(record)):
        return fn(), used


def epoch_data():
    pos, feat, y, ids = synthetic_dataset(EPOCH_PLOTS, EPOCH_POINTS, seed=3)
    pos = [p[: 180 + 9 * i] for i, p in enumerate(pos)]  # clouds of several sizes
    feat = [f[: 180 + 9 * i] for i, f in enumerate(feat)]
    return DeviceDataset.from_clouds(pos, feat, y, ids, device="cpu")


def _epochs(kwargs, state, mesh):
    """One epoch each through train_epoch, the fused and the scan epoch from
    one state (FPS starts and dropout drawn from the step generator), and the
    evaluations after the scan epoch. At lr 1e-6: Adam moves a parameter by
    about lr whatever float noise its gradient holds, so at the default lr
    the summation order of the mesh would part its later steps from one
    process's by far more than float32 rounding."""
    ds = epoch_data()
    cfg = TrainConfig(hp=HyperParams(batch_size=EPOCH_BATCH, num_augs=1, lr=1e-6))
    out = {}
    for path in ("plain", "fused", "scan"):
        trainer = Trainer(_model(kwargs, state), cfg, device="cpu", mesh=mesh)
        if path == "plain":
            batches = ds.batches(EPOCH_BATCH, seed=EPOCH_SEED, num_augs=1, shuffle=True)
            loss, n = trainer.train_epoch(batches, trainer.step_generator(EPOCH_SEED))
        elif path == "fused":
            loss, n = trainer.train_epoch_fused(ds, EPOCH_SEED, batch_size=EPOCH_BATCH, num_augs=1)
        else:
            loss, n = trainer.train_epoch_scan(ds, EPOCH_SEED, batch_size=EPOCH_BATCH, num_augs=1)
        out[path] = dict(loss=loss, n=n, params=[p.detach().clone().numpy()
                                                 for p in trainer.model.parameters()])
    out["evaluate"] = trainer.evaluate(ds.batches(EPOCH_BATCH))
    out["evaluate_scan"] = trainer.evaluate_scan(ds, batch_size=EPOCH_BATCH)
    out["evaluate_fused"] = trainer.evaluate_fused(ds, batch_size=EPOCH_BATCH)
    out["predict"] = trainer.predict(ds.batches(EPOCH_BATCH))
    return out


def _serving(kwargs, state, mesh):
    model = _model(kwargs, state)
    ds = epoch_data()
    batch = next(iter(ds.batches(EPOCH_BATCH)))
    out = dict(serve=compile_inference(model, "cpu", mesh=mesh)(batch).numpy(),
               dataset=compile_dataset_inference(model, "cpu", mesh=mesh)(ds, EPOCH_BATCH))
    if mesh is not None:
        odd = CloudBatch(pos=batch.pos[:3], feat=batch.feat[:3], mask=batch.mask[:3])
        try:
            compile_inference(model, "cpu", mesh=mesh)(odd)
            out["odd_batch"] = "served"
        except ValueError as e:
            out["odd_batch"] = str(e)
    return out


def _sweep(kwargs, mesh):
    ds = epoch_data()
    val = DeviceDataset.from_clouds(*synthetic_dataset(4, EPOCH_POINTS, seed=5), device="cpu")
    sweep = VmappedSweep(PointNet2Regressor(**kwargs), SWEEP_LRS, SWEEP_WDS, patience=1,
                         mesh=mesh, device="cpu")
    res = sweep.run(ds, val, seed=2, batch_size=EPOCH_BATCH, num_epochs=2, log_fn=lambda _: None)
    return dict(results=[(r.best_val_mse, r.epochs_run, r.stopped_early) for r in res],
                local=list(sweep.local), built=[t is not None for t in sweep.trials])


def _fit(kwargs, state, mesh, out_dir):
    ds = epoch_data()
    val = DeviceDataset.from_clouds(*synthetic_dataset(4, EPOCH_POINTS, seed=5), device="cpu")
    cfg = TrainConfig(hp=HyperParams(batch_size=EPOCH_BATCH, num_augs=0, patience=5))
    trainer = Trainer(_model(kwargs, state), cfg, device="cpu", mesh=mesh)
    lines = []
    hist = trainer.fit(ds, val, num_epochs=2, csv_path=os.path.join(out_dir, "log.csv"),
                       checkpoint_dir=os.path.join(out_dir, "ckpt"), log_fn=lines.append)
    return dict(train=hist["train_mse"], val=hist["val_mse"], best=hist["best_val_mse"],
                logged=len(lines))


def _draws(mesh):
    """``rand_rows`` under the mesh against the one-process draw it slices."""
    g = torch.Generator().manual_seed(7)
    with dp.data_parallel(mesh):
        mine = dp.rand_rows((3, 5), g, "cpu")
    whole = torch.rand((6, 5), generator=torch.Generator().manual_seed(7))
    r = dp.dp_rank(mesh)
    return bool(torch.equal(mine, whole[3 * r:3 * r + 3]))


def _cli(work_dir):
    from dl_biomass_tpu_torch.__main__ import main

    os.chdir(work_dir)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["train", "--config", "cfg.json", "--model_dir", "mesh_models",
                   "--device", "cpu"])
    return dict(rc=rc, printed=out.getvalue())


def run_checks(rank, world, device, tmp):
    """Every check over the 2-rank mesh, then the one-process runs they are
    held against, split between the ranks (they need no collective)."""
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = dp.make_mesh(2, 1, "cpu")
    f32, small = inputs["models"]["f32"], inputs["models"]["small"]
    fused, folded = inputs["models"]["fused_sa"], inputs["models"]["analytic_remat"]
    uneven = _batch(inputs["batches"]["uneven"])
    res = dict(coordinate=tuple(mesh.get_coordinate()), draws=_draws(mesh))
    for case, arrays in inputs["batches"].items():
        res[f"step_{case}"], res[f"stats_{case}"] = _stats_used(
            lambda: _step(*f32, _batch(arrays), mesh))
    res["fused_sa_mesh"] = _step(*fused, uneven, mesh)
    res["analytic_remat_mesh"] = _step(*folded, uneven, mesh)
    res["epochs_mesh"] = _epochs(*small, mesh)
    res["serving_mesh"] = _serving(*small, mesh)
    res["sweep_mesh"] = _sweep(small[0], mesh)
    res["fit_mesh"] = _fit(*small, mesh, os.path.join(tmp, "fit"))
    odd = _batch(tuple(a[:7] for a in inputs["batches"]["even"]))
    try:
        Trainer(_model(*f32), TrainConfig(), device="cpu", mesh=mesh).step(odd)
        res["odd_step"] = "stepped"
    except ValueError as e:
        res["odd_step"] = str(e)
    res["cli"] = _cli(inputs["cli_dir"])
    if rank == 0:
        res["epochs_one"] = _epochs(*small, None)
    else:
        res["stats_one"] = {case: _stats_used(lambda: _step(*f32, _batch(arrays), None),
                                              parts=world)[1]
                            for case, arrays in inputs["batches"].items()}
        res["fused_sa_one"] = _step(*fused, uneven, None)
        res["analytic_remat_one"] = _step(*folded, uneven, None)
        res["serving_one"] = _serving(*small, None)
        res["sweep_one"] = _sweep(small[0], None)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
