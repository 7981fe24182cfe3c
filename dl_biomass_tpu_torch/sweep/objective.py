"""Training objective for sequential studies (port of ``dl_biomass_tpu/sweep/objective.py``).

Parity with the reference's Optuna objective (``hyperparameter_tuning.py:57-227``):
per trial — suggest hyperparameters (the reference's exact active search space:
lr log-uniform 1e-6..1e-1, num_augs 0..10, batch_size 8..40 step 4, patience
5..30 step 5; the rest fixed at the committed constants), rebuild the model,
train with early stopping, report val MSE per epoch, honor pruning, and return
``min(val_mse_list)``.

Unlike the reference, datasets are NOT re-read from disk per trial — the
device-resident dataset is shared across trials.

Seeds: trial n draws from ``trial_seed = derive_seed(seed, n)``: its initial
weights (``models/pointnet2.seeded_init``) and, for its epoch e, the order,
augmentation and step randomness of ``train_epoch_fused(ds,
derive_seed(trial_seed, e))``. (The JAX package folds ``trial.number`` into a
``jax.random.key(seed)``; no torch stream reproduces that, so the rule is the
port's own.)
"""

from __future__ import annotations

from typing import Callable, Optional

from dl_biomass_tpu_torch.core.config import HyperParams, TrainConfig
from dl_biomass_tpu_torch.io.device_data import derive_seed
from dl_biomass_tpu_torch.sweep.study import Trial, TrialPruned


def make_training_objective(
    train_ds,
    val_ds,
    *,
    base_cfg: Optional[TrainConfig] = None,
    max_num_epochs: int = 100,
    seed: int = 0,
    search_batch_and_augs: bool = True,
    log_fn=print,
    device=None,
) -> Callable[[Trial], float]:
    """The objective over two ``DeviceDataset``s, training on ``device``
    (None: the card, which must exist)."""
    base_cfg = base_cfg or TrainConfig()

    def objective(trial: Trial) -> float:
        hp = HyperParams(
            lr=trial.suggest_float("lr", 1e-6, 1e-1, log=True),
            num_augs=trial.suggest_int("num_augs", 0, 10) if search_batch_and_augs
            else base_cfg.hp.num_augs,
            batch_size=trial.suggest_int("batch_size", 8, 40, step=4)
            if search_batch_and_augs else base_cfg.hp.batch_size,
            patience=trial.suggest_int("patience", 5, 30, step=5),
            weight_decay=base_cfg.hp.weight_decay,
            num_points=base_cfg.hp.num_points,
            ground_filter_height=base_cfg.hp.ground_filter_height,
            activation_function=base_cfg.hp.activation_function,
            neuron_multiplier=base_cfg.hp.neuron_multiplier,
            dropout_probability=base_cfg.hp.dropout_probability,
            optimizer=base_cfg.hp.optimizer,
        )
        cfg = TrainConfig(hp=hp, model=base_cfg.model, num_epochs=max_num_epochs)

        from dl_biomass_tpu_torch.models.pointnet2 import build_model, seeded_init
        from dl_biomass_tpu_torch.train.trainer import EarlyStopping, Trainer

        tseed = derive_seed(seed, trial.number)
        model = seeded_init(tseed, build_model, cfg, train_ds.num_features)
        trainer = Trainer(model, cfg, device)

        stopper = EarlyStopping(hp.patience, True)
        best = float("inf")
        for epoch in range(max_num_epochs):
            # per-step fused path: the step count S = f(num_augs, batch_size)
            # changes from trial to trial, and nothing here depends on it
            trainer.train_epoch_fused(train_ds, derive_seed(tseed, epoch),
                                      batch_size=hp.batch_size, num_augs=hp.num_augs,
                                      shuffle=True)
            val_mse = trainer.evaluate_fused(val_ds, batch_size=hp.batch_size)
            best = min(best, val_mse)
            trial.report(val_mse, epoch)
            if stopper.update(val_mse):
                log_fn(f"  trial {trial.number}: early stop at epoch {epoch}")
                return best
            if trial.should_prune():
                log_fn(f"  trial {trial.number}: pruned at epoch {epoch}")
                raise TrialPruned()
        return best

    return objective
