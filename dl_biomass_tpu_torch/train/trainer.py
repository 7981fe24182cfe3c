"""Training loop (port of ``dl_biomass_tpu/train/trainer.py``).

  * torch ``Adam(lr, weight_decay)``: L2 folded into the gradient before the
    moment updates, which is what the JAX package builds from optax's
    ``add_decayed_weights`` + ``adam``; ``AdamW`` is torch's own;
  * the weighted 4-component MSE (``train/loss.py``), pad clouds weighted 0;
  * early stopping with the reference's trigger rule (``main.py:226-235``);
  * a per-epoch CSV line ``epoch, train_mse, val_mse``, save-on-best
    checkpoints of model + optimizer state, and resume.

``Trainer.step`` is the body of the JAX package's ``_step_core``: one
train-mode forward (batch statistics, their running update, the head's
dropout), the loss, its gradients and one optimizer step. Randomness (FPS
starts, dropout) comes from the ``torch.Generator`` the caller passes. The
loop syncs with the host once per epoch, not per step.

Over a ``DeviceDataset`` (``io/device_data.py``) an epoch gathers, augments
and steps on the device from one integer seed: ``train_epoch_fused`` hands
each step its specs, ``train_epoch_scan`` hands the epoch's specs over as one
tensor each and indexes them per step; both give the losses and parameters
of ``train_epoch(ds.batches(...), step_generator(seed))``, bit for bit.

Data parallelism (``mesh=``, a ``parallel.make_mesh`` mesh; the JAX package's
params replicated and batch sharded over ``dp``): every rank holds the same
parameters, buffers and Adam state (rank 0's, broadcast at the start and
after a resume) and is handed the whole batch, of which it steps on its
``dp`` slice (a batch the ``dp`` size does not divide raises). The FPS
starts and the dropout are drawn for the whole batch from the shared
generator and sliced (``parallel/mesh.rand_rows``); the BatchNorm statistics
and kernel 6's sums are the whole batch's. The loss is the whole batch's
mean: each rank's share is its clouds' squared errors over the count of
real clouds of the whole batch, so the shares add up to the mean however
the pad clouds fall, and the gradients are summed over the ranks before the
optimizer step. Evaluation's losses and ``predict``'s rows are the whole
batch's on every rank; ``fit`` takes its decisions from rank 0's numbers,
and only rank 0 writes checkpoints, the CSV and TensorBoard.

Under ``mp`` > 1, ``step``, ``evaluate`` and ``predict`` hand the model each
rank's ``mp`` slice of the points too (``parallel/mesh.shard_points``; the
model splits SA1 and SA2 by centroid over ``mp``); the epochs over a
``DeviceDataset`` batch as the JAX trainer does, over ``dp`` only, and run
replicated over ``mp``. Either way every rank backpropagates its loss over
the ``mp`` size and the gradients are summed over the whole mesh, so the
loss counts once.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import CloudBatch, resolve_device
from dl_biomass_tpu_torch.core.config import TrainConfig
from dl_biomass_tpu_torch.models.pointnet2 import model_to_dict
from dl_biomass_tpu_torch.parallel import mesh as dp
from dl_biomass_tpu_torch.train import checkpoint
from dl_biomass_tpu_torch.train.loss import weighted_component_mse



def _is_device_dataset(x) -> bool:
    return hasattr(x, "epoch_spec_arrays")


def make_optimizer(params, hp) -> torch.optim.Optimizer:
    """torch's own ``Adam`` (L2 weight decay inside the gradient) or ``AdamW``."""
    if hp.optimizer == "Adam":
        return torch.optim.Adam(params, lr=hp.lr, weight_decay=hp.weight_decay)
    if hp.optimizer == "AdamW":
        return torch.optim.AdamW(params, lr=hp.lr, weight_decay=hp.weight_decay)
    raise ValueError(f"unknown optimizer {hp.optimizer!r}")


class EarlyStopping:
    """The reference's trigger rule (``main.py:226-235``): count up when val MSE
    rises above the last *accepted* value; reset and accept otherwise."""

    def __init__(self, patience: int, enabled: bool = True):
        self.patience = patience
        self.enabled = enabled
        self.trigger_times = 0
        self.last_val = np.inf

    def update(self, val_mse: float) -> bool:
        """True when training should stop."""
        if not self.enabled:
            return False
        if val_mse > self.last_val:
            self.trigger_times += 1
            return self.trigger_times >= self.patience
        self.trigger_times = 0
        self.last_val = val_mse
        return False


def _pad_weight(batch: CloudBatch) -> torch.Tensor:
    return batch.mask.any(dim=1)  # fully padded clouds weigh 0


class Trainer:
    """Trains ``model`` on ``device`` (None: the card, which must exist;
    ``"cpu"`` runs the kernels' plain versions), over the ``dp`` axis of
    ``mesh`` where one is given (every rank of it builds its ``Trainer``)."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, device=None, mesh=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.mesh = mesh
        self.optimizer = make_optimizer(self.model.parameters(), cfg.hp)
        if mesh is not None:
            dp.broadcast_module(self.model)

    def _loss(self, out: torch.Tensor, batch: CloudBatch) -> torch.Tensor:
        """The weighted MSE of this rank's clouds over the real clouds of the
        whole batch (the loss itself without a mesh)."""
        w = _pad_weight(batch)
        total = None if self.mesh is None else dp.sum_dp(w.sum().float(), self.mesh)
        return weighted_component_mse(out, batch.y, w, total_weight=total)

    # ---- steps ---------------------------------------------------------------

    def _parts(self) -> int:
        return 1 if self.mesh is None else dp.mp_size(self.mesh)

    def _input(self, batch: CloudBatch, points: bool) -> CloudBatch:
        """The model's input on this rank: its ``dp`` slice, and with
        ``points`` its ``mp`` slice of the points."""
        return dp.shard_points(batch, self.mesh) if points else dp.shard_batch(batch, self.mesh)

    def step(self, batch: CloudBatch,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One gradient step; returns the loss (a device tensor, not synced).
        After it, each parameter's ``.grad`` holds this step's gradient (under
        a mesh, the whole batch's, summed over the ranks; under ``mp`` > 1
        each rank computes its slice of the points)."""
        return self._step(batch, generator, points=True)

    def _step(self, batch: CloudBatch, generator: Optional[torch.Generator],
              points: bool) -> torch.Tensor:
        batch = batch.to(self.device)
        parts = self._parts()
        points = points and parts > 1
        with dp.data_parallel(self.mesh, points=points):
            local = dp.shard_batch(batch, self.mesh)
            self.optimizer.zero_grad(set_to_none=True)
            out = self.model(self._input(batch, points), train=True, generator=generator)
            loss = self._loss(out, local)
            (loss / parts if parts > 1 else loss).backward()
        if self.mesh is not None:
            dp.sum_grads(self.model.parameters(), self.mesh)
        self.optimizer.step()
        return dp.sum_dp(loss.detach(), self.mesh)

    @torch.inference_mode()
    def _eval_batch(self, batch: CloudBatch, points: bool = True):
        """(loss, predictions, real-cloud mask) of one eval-mode forward; under
        a mesh the whole batch's loss and rows."""
        batch = batch.to(self.device)
        points = points and self._parts() > 1
        with dp.data_parallel(self.mesh, points=points):
            local = dp.shard_batch(batch, self.mesh)
            out = self.model(self._input(batch, points), train=False)
            loss = dp.sum_dp(self._loss(out, local), self.mesh)
            return loss, dp.gather_dp(out, self.mesh), _pad_weight(batch)

    # ---- loops ---------------------------------------------------------------

    def train_epoch(self, batches, generator: Optional[torch.Generator] = None, *,
                    seed: Optional[int] = None) -> Tuple[float, int]:
        """(mean train loss, real clouds seen); one host sync at the end.
        ``batches`` yields CloudBatches, or is a ``DeviceDataset``: then the
        scan or the fused epoch by ``cfg.scan_epochs``, at ``cfg.hp.batch_size``
        and ``cfg.hp.num_augs``, drawn from ``seed`` (no ``generator``)."""
        if _is_device_dataset(batches):
            if seed is None or generator is not None:
                raise ValueError("train_epoch over a DeviceDataset draws from seed= alone")
            epoch = self.train_epoch_scan if self.cfg.scan_epochs else self.train_epoch_fused
            return epoch(batches, seed, batch_size=self.cfg.hp.batch_size,
                         num_augs=self.cfg.hp.num_augs)
        losses, counts = [], []
        for batch in batches:
            losses.append(self.step(batch, generator))
            counts.append(_pad_weight(batch).sum())
        if not losses:
            raise ValueError("train_epoch got no batches")
        losses = torch.stack(losses).cpu().numpy()
        return float(np.mean(losses.astype(np.float64))), int(torch.stack(counts).sum())

    def _device_epoch(self, ds, seed: Optional[int], batch_size: int, num_augs: int,
                      shuffle: bool, scan: bool, train: bool) -> Tuple[float, int]:
        """One epoch over a DeviceDataset: every batch gathered, augmented and
        stepped (or evaluated) on the device, one host sync at the end. ``scan``
        hands the specs over as one tensor each, else one step's at a time."""
        idxs, augs, valids, b0s = ds.epoch_spec_arrays(batch_size, seed=seed,
                                                       num_augs=num_augs, shuffle=shuffle)
        specs = [ds._to_device(a) for a in (idxs, augs, valids)] if scan else None
        generator = self.step_generator(seed) if train else None
        losses = []
        for si in range(len(b0s)):
            per = [a[si] for a in specs] if scan else (idxs[si], augs[si], valids[si])
            batch = ds.assemble(*per, ds.aug_seed(seed, int(b0s[si])), bool(augs[si].any()))
            losses.append(self._step(batch, generator, points=False) if train
                          else self._eval_batch(batch, points=False)[0])
        if not losses:
            raise ValueError("the DeviceDataset holds no plots")
        loss = float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
        return loss, int(valids.sum())

    def train_epoch_fused(self, ds, seed: int, *, batch_size: int, num_augs: int = 0,
                          shuffle: bool = True) -> Tuple[float, int]:
        """``train_epoch`` over a DeviceDataset, each step handed its own specs;
        the steps draw from ``step_generator(seed)``, the order and the
        augmentation from ``seed`` (``ds.epoch_specs``)."""
        return self._device_epoch(ds, seed, batch_size, num_augs, shuffle, False, True)

    def train_epoch_scan(self, ds, seed: int, *, batch_size: int, num_augs: int = 0,
                         shuffle: bool = True) -> Tuple[float, int]:
        """``train_epoch_fused`` with the epoch's specs handed over as one tensor
        each: the same losses and parameters, bit for bit."""
        return self._device_epoch(ds, seed, batch_size, num_augs, shuffle, True, True)

    def evaluate_fused(self, ds, *, batch_size: int) -> float:
        """``evaluate`` over a DeviceDataset (in order, unaugmented)."""
        return self._device_epoch(ds, None, batch_size, 0, False, False, False)[0]

    def evaluate_scan(self, ds, *, batch_size: int) -> float:
        """``evaluate_fused`` with the specs handed over as one tensor each."""
        return self._device_epoch(ds, None, batch_size, 0, False, True, False)[0]

    def evaluate(self, batches) -> float:
        """Mean eval loss over the batches (or a DeviceDataset: ``evaluate_scan``
        or ``evaluate_fused`` by ``cfg.scan_epochs`` at ``cfg.hp.batch_size``);
        one host sync at the end."""
        if _is_device_dataset(batches):
            epoch = self.evaluate_scan if self.cfg.scan_epochs else self.evaluate_fused
            return epoch(batches, batch_size=self.cfg.hp.batch_size)
        losses = [self._eval_batch(b)[0] for b in batches]
        if not losses:
            raise ValueError("evaluate got no batches")
        return float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))

    def predict(self, batches: Iterable[CloudBatch]) -> np.ndarray:
        """(clouds, 4) predictions of the real clouds, in batch order; every
        batch is queued before the one host sync."""
        evals = [self._eval_batch(b) for b in batches]
        out = torch.cat([e[1] for e in evals]).cpu().numpy()
        return out[torch.cat([e[2] for e in evals]).cpu().numpy()]

    def epoch_seed(self, epoch: int) -> int:
        """The seed of ``epoch``, from ``cfg.seed``: a resumed run draws what an
        uninterrupted one would have."""
        return int(self.cfg.seed) * 1_000_003 + epoch

    def step_generator(self, seed: int) -> torch.Generator:
        """The steps' randomness (FPS starts, dropout) of the epoch of ``seed``."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def epoch_generator(self, epoch: int) -> torch.Generator:
        """The step randomness of ``epoch`` (``step_generator(epoch_seed(epoch))``)."""
        return self.step_generator(self.epoch_seed(epoch))

    def fit(self, train_batches_fn: Callable[[int], Iterable[CloudBatch]],
            val_batches_fn: Callable[[], Iterable[CloudBatch]], *,
            num_epochs: Optional[int] = None, csv_path: Optional[str] = None,
            checkpoint_dir: Optional[str] = None, log_fn: Callable[[str], None] = print,
            metric_writer=None, resume: bool = False) -> Dict[str, Any]:
        """Training with early stopping and save-on-best.

        ``train_batches_fn(epoch)`` and ``val_batches_fn()`` yield CloudBatches;
        either may instead be a ``DeviceDataset``, trained through
        ``train_epoch_scan`` or ``train_epoch_fused`` (evaluated through
        ``evaluate_scan`` or ``evaluate_fused``) by ``cfg.scan_epochs``, with
        ``cfg.hp.batch_size`` and ``cfg.hp.num_augs``, epoch e drawn from
        ``epoch_seed(e)``. ``metric_writer`` (``utils/tboard.SummaryWriter``)
        takes each epoch's "Training MSE" and "Validation MSE". Returns the history: per-epoch train/val MSE, seconds
        and clouds/s, ``best_val_mse``, ``best_state`` (a copy of the best model
        ``state_dict``) and ``stopped_early``."""
        cfg = self.cfg
        num_epochs = num_epochs if num_epochs is not None else cfg.num_epochs
        stopper = EarlyStopping(cfg.hp.patience, cfg.early_stopping)
        writes = dp.is_writer(self.mesh)
        if not writes:  # the other ranks of a mesh: rank 0 logs and writes
            log_fn, metric_writer, csv_path = (lambda _: None), None, None
        history: Dict[str, Any] = {"epoch": [], "train_mse": [], "val_mse": [],
                                   "epoch_seconds": [], "clouds_per_sec": []}
        best_val = np.inf
        best_state = copy.deepcopy(self.model.state_dict())
        stopped_early = False
        start_epoch = 0

        if resume and checkpoint_dir:
            meta = checkpoint.restore_latest(checkpoint_dir, self.model, self.optimizer)
            if self.mesh is not None:
                dp.broadcast_module(self.model)
                dp.broadcast_optimizer(self.optimizer)
            if meta is not None:
                start_epoch = int(meta["epoch"]) + 1
                best_val = float(meta["val_mse"])
                stopper.last_val = best_val
                best_state = copy.deepcopy(self.model.state_dict())
                log_fn(f"Resuming from epoch {start_epoch} (best val MSE {best_val:.4f})")

        if checkpoint_dir and writes:
            # sidecar so that evaluation can rebuild the exact model later
            os.makedirs(checkpoint_dir, exist_ok=True)
            with open(os.path.join(checkpoint_dir, "model_config.json"), "w") as f:
                json.dump({"model": model_to_dict(self.model), "train": cfg.to_dict()}, f,
                          indent=2)

        for epoch in range(start_epoch, num_epochs):
            t0 = time.perf_counter()
            if _is_device_dataset(train_batches_fn):
                train_mse, n_clouds = self.train_epoch(train_batches_fn,
                                                       seed=self.epoch_seed(epoch))
            else:
                train_mse, n_clouds = self.train_epoch(train_batches_fn(epoch),
                                                       self.epoch_generator(epoch))
            val_mse = self.evaluate(val_batches_fn if _is_device_dataset(val_batches_fn)
                                    else val_batches_fn())
            if self.mesh is not None:  # every rank decides on rank 0's numbers
                train_mse, val_mse = dp.same_on_all([train_mse, val_mse], self.device)
            dt = time.perf_counter() - t0

            history["epoch"].append(epoch)
            history["train_mse"].append(train_mse)
            history["val_mse"].append(val_mse)
            history["epoch_seconds"].append(dt)
            history["clouds_per_sec"].append(n_clouds / dt if dt > 0 else 0.0)

            if csv_path:
                with open(csv_path, "a") as f:
                    f.write(f"{epoch}, {train_mse}, {val_mse}\n")
            if metric_writer is not None:
                metric_writer.scalar("Training MSE", train_mse, epoch)
                metric_writer.scalar("Validation MSE", val_mse, epoch)

            if val_mse <= best_val:
                best_val = val_mse
                best_state = copy.deepcopy(self.model.state_dict())
                if checkpoint_dir and writes:
                    checkpoint.save_checkpoint(checkpoint_dir, self.model, self.optimizer,
                                               epoch=epoch, val_mse=val_mse)
                log_fn(f"    Saving model for epoch {epoch}")

            log_fn(f"    Epoch: {epoch}  | Mean val MSE: {round(val_mse, 2)}"
                   f"  | Mean train MSE: {round(train_mse, 2)}")

            if stopper.update(val_mse):
                log_fn(f"\nEarly stopping at epoch {epoch}!\n")
                stopped_early = True
                break

        history["best_val_mse"] = float(best_val)
        history["best_state"] = best_state
        history["stopped_early"] = stopped_early
        return history
