"""Trial-parallel hyperparameter sweeps (port of ``dl_biomass_tpu/sweep/vmapped.py``).

The reference explores hyperparameters with *sequential* Optuna trials, each
rebuilding datasets and model and running a full early-stopped training loop
(``hyperparameter_tuning.py:57-227``). The JAX package trains T trials over
(lr, weight decay) at once under one vmapped step, sharing every batch, each
trial with its own optimizer hyperparameters and early-stopping mask.

The port's kernels are launched through ctypes (``ops/_build.py``), not as
torch operators, so ``torch.func.vmap`` cannot batch them. Here the T trials
run **in turn** on each shared batch: the batch is gathered and augmented
once on the device, then every active trial takes its step on it. Each trial
is a ``Trainer`` of its own: its own module, its own optimizer (torch
``Adam`` with the L2 term folded into the gradient, or decoupled ``AdamW``:
the update rule of the JAX package's ``_adam_update``) at that trial's lr and
weight decay, and its own step generator. A stopped trial takes no step and
no train-mode forward, so its parameters, optimizer moments and BatchNorm
running statistics stay as they were, bit for bit (the JAX package's
``jnp.where`` freeze). Folding the trials into the kernels' batch axis waits
(ROADMAP B).

Seeds, from the ``seed`` of ``run``: trial t's initial weights from
``derive_seed(seed, t)`` (``models/pointnet2.seeded_init``); epoch e's
order and augmentation from ``epoch_seed = derive_seed(seed, e)``
(``DeviceDataset.batches``), shared by every trial; trial t's FPS starts and
dropout in epoch e from ``derive_seed(epoch_seed, t)``. So trial t's run is
a ``Trainer`` run of the same initial weights, lr and weight decay over
``ds.batches(batch_size, seed=epoch_seed, num_augs=, shuffle=True)`` with the
generator ``trial_generator(t, epoch_seed)``, bit for bit.

Over a mesh (``mesh=``, ``parallel.make_mesh``; every rank of the world in
it) the T trials split over the mesh's ranks, as the JAX package shards them
over every mesh axis: rank r runs trials ``r*T/R .. (r+1)*T/R - 1`` in turn on
each shared batch, and each epoch's validation losses are gathered to every
rank, which then takes the same early-stopping decisions and returns the same
results.

Axes that change shapes (batch size, num_augs, point count) group trials into
separate runs — see :func:`grid_sweep`.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.core.config import HyperParams, TrainConfig
from dl_biomass_tpu_torch.io.device_data import derive_seed


@dataclass
class TrialResult:
    lr: float
    weight_decay: float
    batch_size: int
    num_augs: int
    best_val_mse: float
    epochs_run: int
    stopped_early: bool


class VmappedSweep:
    """T trials over (lr, weight_decay) with shared data, run in turn on each
    batch. ``model`` is the template: every trial builds its architecture
    (``model_to_dict``) with weights of its own. Under ``mesh`` this rank runs
    its share of the trials (``local``)."""

    def __init__(self, model, lrs: Sequence[float], wds: Sequence[float],
                 optimizer: str = "Adam", patience: int = 10,
                 early_stopping: bool = True, mesh=None, device=None):
        assert len(lrs) == len(wds)
        ranks, rank = 1, 0
        if mesh is not None:
            ranks = mesh.size()
            if len(lrs) % ranks:
                raise ValueError(f"{len(lrs)} trials not divisible by {ranks} mesh devices")
            import torch.distributed as dist

            if ranks != dist.get_world_size():
                raise ValueError(f"a sweep's mesh must hold every rank: {ranks} of "
                                 f"{dist.get_world_size()}")
            rank = dist.get_rank()
        self.mesh, self.rank, self.ranks = mesh, rank, ranks
        per = len(lrs) // ranks
        self.local = range(rank * per, (rank + 1) * per)
        self.model = model
        self.lrs = [float(x) for x in lrs]
        self.wds = [float(x) for x in wds]
        self.t = len(self.lrs)
        self.patience = patience
        self.early_stopping = early_stopping
        self.optimizer = optimizer
        self.device = resolve_device(device)
        self.trials: list = []

    # -- state -------------------------------------------------------------------

    def trial_config(self, i: int) -> TrainConfig:
        """Trial i's config: its lr and weight decay, the sweep's optimizer."""
        return TrainConfig(hp=HyperParams(lr=self.lrs[i], weight_decay=self.wds[i],
                                          optimizer=self.optimizer, patience=self.patience),
                           early_stopping=self.early_stopping)

    def init_states(self, seed: int) -> list:
        """One ``Trainer`` a trial of this rank on the sweep's device (None in
        the places of other ranks' trials), trial t's weights drawn from
        ``derive_seed(seed, t)``; kept as ``self.trials``."""
        from dl_biomass_tpu_torch.models.pointnet2 import (model_from_dict, model_to_dict,
                                                           seeded_init)
        from dl_biomass_tpu_torch.train.trainer import Trainer

        arch = model_to_dict(self.model)
        self.trials = [Trainer(seeded_init(derive_seed(seed, i), model_from_dict, arch),
                               self.trial_config(i), self.device) if i in self.local else None
                       for i in range(self.t)]
        return self.trials

    def trial_generator(self, i: int, epoch_seed: int) -> torch.Generator:
        """Trial i's FPS starts and dropout in the epoch of ``epoch_seed``."""
        return self.trials[i].step_generator(derive_seed(epoch_seed, i))

    # -- steps -------------------------------------------------------------------

    def evaluate(self, batches, active: Optional[np.ndarray] = None) -> np.ndarray:
        """Each trial's mean eval-mode loss over ``batches`` (on one batch, the
        JAX package's vmapped ``_eval_step``); NaN for a trial outside
        ``active``. Under a mesh every rank evaluates its trials and gets
        every trial's loss."""
        out = np.full(self.t, np.nan)
        for i in self.local:
            if active is None or active[i]:
                out[i] = self.trials[i].evaluate(batches)
        if self.mesh is None:
            return out
        from dl_biomass_tpu_torch.parallel import mesh as dp

        mine = torch.tensor(out[self.local.start:self.local.stop], dtype=torch.float64,
                            device=self.device)
        return dp.gather_slices(mine, self.rank, self.ranks, None).cpu().numpy()

    def _validate(self, val_ds, batch_size: int, active: np.ndarray) -> np.ndarray:
        """Every active trial's mean loss over the validation batches, which
        are gathered once and shared; NaN for a stopped trial."""
        return self.evaluate(list(val_ds.batches(batch_size)), active)

    # -- run ------------------------------------------------------------------------

    def run(
        self,
        train_ds,
        val_ds,
        *,
        seed: int,
        batch_size: int,
        num_augs: int = 0,
        num_epochs: int = 100,
        log_fn=print,
    ) -> List[TrialResult]:
        self.init_states(seed)
        active = np.ones(self.t, bool)
        trigger = np.zeros(self.t, int)
        last_val = np.full(self.t, np.inf)
        best_val = np.full(self.t, np.inf)
        epochs_run = np.zeros(self.t, int)

        for epoch in range(num_epochs):
            es = derive_seed(seed, epoch)
            gens = {i: self.trial_generator(i, es) for i in np.flatnonzero(active)
                    if i in self.local}
            for batch in train_ds.batches(batch_size, seed=es, num_augs=num_augs, shuffle=True):
                for i, gen in gens.items():
                    self.trials[i].step(batch, gen)
            val_mse = self._validate(val_ds, batch_size, active)

            epochs_run[active] = epoch + 1
            best_val = np.where(active, np.minimum(best_val, val_mse), best_val)
            if self.early_stopping:
                rising = val_mse > last_val
                trigger = np.where(active & rising, trigger + 1, np.where(active, 0, trigger))
                last_val = np.where(active & ~rising, val_mse, last_val)
                newly_stopped = active & (trigger >= self.patience)
                active = active & ~newly_stopped
            if self.rank == 0:
                log_fn(f"  epoch {epoch}: active {int(active.sum())}/{self.t}, "
                       f"best val {np.nanmin(best_val):.4f}")
            if not active.any():
                break

        return [
            TrialResult(
                lr=self.lrs[i], weight_decay=self.wds[i],
                batch_size=batch_size, num_augs=num_augs,
                best_val_mse=float(best_val[i]), epochs_run=int(epochs_run[i]),
                stopped_early=bool(~active[i]),
            )
            for i in range(self.t)
        ]


def grid_sweep(
    model_fn,
    train_ds,
    val_ds,
    *,
    lrs: Sequence[float],
    wds: Sequence[float],
    batch_sizes: Sequence[int] = (36,),
    num_augs: int = 0,
    num_epochs: int = 100,
    patience: int = 10,
    optimizer: str = "Adam",
    seed: int = 0,
    study=None,
    mesh=None,
    log_fn=print,
    device=None,
) -> List[TrialResult]:
    """Full (lr x wd) x batch-size grid: the (lr, wd) product runs as one
    sweep per batch size, seeded ``derive_seed(seed, batch_size)``. Results
    are optionally recorded into a Study for the reporting surface
    (trials_dataframe / param importances). Under ``mesh`` every grid's
    trials split over its ranks, as ``VmappedSweep`` splits them."""
    pairs = list(itertools.product(lrs, wds))
    all_results: List[TrialResult] = []
    for bs in batch_sizes:
        sweep = VmappedSweep(
            model_fn, [p[0] for p in pairs], [p[1] for p in pairs],
            optimizer=optimizer, patience=patience, mesh=mesh, device=device,
        )
        log_fn(f"sweep: {len(pairs)} trials in turn on each batch @ batch_size={bs}")
        all_results += sweep.run(
            train_ds, val_ds, seed=derive_seed(seed, bs),
            batch_size=bs, num_augs=num_augs, num_epochs=num_epochs, log_fn=log_fn,
        )
    if study is not None:
        from dl_biomass_tpu_torch.sweep.study import FrozenTrial, TrialState

        for r in all_results:
            ft = FrozenTrial(number=len(study.trials))
            ft.params = {"lr": r.lr, "weight_decay": r.weight_decay,
                         "batch_size": r.batch_size, "num_augs": r.num_augs}
            ft.value = r.best_val_mse
            ft.state = TrialState.COMPLETE
            study.trials.append(ft)
    return all_results
