"""The port's sweeps against the JAX package's, on the CPU.

- ``sweep/study.py`` (a copy): the same suggestions from the same sampler
  seeds (random, TPE, grid), the same pruning decisions, and a study saved by
  either package loads in the other.
- ``sweep/vmapped.py``: the trials' update rule (torch ``Adam`` / ``AdamW``)
  against ``_adam_update`` over 3 steps (rel <= 1e-6); the eval step against
  the vmapped ``_eval_step`` on each trial's JAX init carried across
  (f32, ``F32_RTOL``); the early-stopping bookkeeping of ``run`` against the
  JAX ``run`` with its compiled steps stubbed, on scripted val MSEs; a stopped
  trial's parameters, moments and running statistics kept bit for bit, and a
  trial's run equal to a ``Trainer`` run bit for bit; a trial count the
  mesh's ranks do not divide refused with the JAX package's message (the
  sweep over a 2-rank mesh is in ``tests/test_torch_mesh.py``).
- ``sweep/objective.py``: the search space and the config each trial trains
  with, against ``make_training_objective``.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl_biomass_tpu.core.cloud import CloudBatch as JaxBatch
from dl_biomass_tpu.models import PointNet2Regressor as JaxModel
from dl_biomass_tpu.sweep import objective as jax_objective
from dl_biomass_tpu.sweep import study as jax_study
from dl_biomass_tpu.sweep import vmapped as jax_vmapped
from dl_biomass_tpu_torch.bridge import from_flax_variables
from dl_biomass_tpu_torch.core.cloud import CloudBatch
from dl_biomass_tpu_torch.io.device_data import DeviceDataset, derive_seed
from dl_biomass_tpu_torch.io.synthetic import synthetic_dataset
from dl_biomass_tpu_torch.models import pointnet2 as port_pointnet2
from dl_biomass_tpu_torch.models.pointnet2 import PointNet2Regressor
from dl_biomass_tpu_torch.sweep import objective as port_objective
from dl_biomass_tpu_torch.sweep import study as port_study
from dl_biomass_tpu_torch.sweep.vmapped import VmappedSweep, grid_sweep
from dl_biomass_tpu_torch.train.trainer import Trainer
from torch_port_helpers import F32_RTOL, rel_err

torch.set_num_threads(1)

ADAM_RTOL = 1e-6  # torch's Adam vs _adam_update in float64: float32 rounding of each step
ADAM_F32_RTOL = 2e-5  # and vs _adam_update in float32 (its bias corrections rounded)


# ---- the copied study ----------------------------------------------------------


def scripted_objective(trial):
    """Every kind of suggestion; the value a fixed function of them."""
    x = trial.suggest_float("x", -5.0, 5.0)
    lr = trial.suggest_float("lr", 1e-6, 1e-1, log=True)
    b = trial.suggest_int("batch_size", 8, 40, step=4)
    act = trial.suggest_categorical("act", ["ReLU", "ELU", "LeakyReLU"])
    return (x - 2.0) ** 2 + (np.log10(lr) + 3) ** 2 + b / 40 + (act == "ELU")


def samplers(mod, kind, seed):
    if kind == "random":
        return mod.RandomSampler(seed)
    if kind == "tpe":
        return mod.TPESampler(seed=seed, n_startup_trials=4)
    return mod.GridSampler({"x": [0.0, 2.0], "lr": [1e-3, 1e-2], "batch_size": [8, 12],
                            "act": ["ReLU", "ELU"]})


def trial_rows(study):
    return [(t.number, t.params, t.value, t.state.value, t.intermediate_values)
            for t in study.trials]


@pytest.mark.parametrize("kind,seed", [("random", 0), ("random", 7), ("tpe", 0), ("tpe", 3),
                                       ("grid", 0)])
def test_samplers_suggest_what_the_jax_package_suggests(kind, seed):
    runs = []
    for mod in (jax_study, port_study):
        study = mod.create_study(sampler=samplers(mod, kind, seed), pruner=None)
        study.optimize(scripted_objective, n_trials=16)
        runs.append(trial_rows(study))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_median_pruner_decides_as_the_jax_package(direction):
    def objective(mod):
        def run(trial):
            x = trial.suggest_float("x", 0.0, 1.0)
            for step in range(8):
                trial.report(x * 10 + 0.3 * np.sin(step + x * 7), step)
                if trial.should_prune():
                    raise mod.TrialPruned()
            return x * 10
        return run

    runs = []
    for mod in (jax_study, port_study):
        study = mod.create_study(direction=direction, sampler=mod.RandomSampler(1),
                                 pruner=mod.MedianPruner(n_startup_trials=2, n_warmup_steps=1))
        study.optimize(objective(mod), n_trials=20)
        runs.append(trial_rows(study))
    assert runs[0] == runs[1]
    assert any(r[3] == "PRUNED" for r in runs[1])


@pytest.mark.parametrize("writer,reader", [(jax_study, port_study), (port_study, jax_study)])
def test_a_study_saved_by_one_package_loads_in_the_other(writer, reader, tmp_path):
    study = writer.create_study(sampler=writer.RandomSampler(2),
                                pruner=writer.MedianPruner(n_startup_trials=2),
                                study_name="cross")

    def objective(trial):
        x = trial.suggest_float("x", 0.0, 1.0)
        for step in range(4):
            trial.report(x + step, step)
            if trial.should_prune():
                raise writer.TrialPruned()
        return x

    study.optimize(objective, n_trials=6)
    path = str(tmp_path / "study.json")
    study.save(path)
    loaded = reader.load_study(path, sampler=reader.TPESampler(seed=0))
    assert loaded.study_name == "cross"
    assert trial_rows(loaded) == trial_rows(study)
    assert loaded.best_params == study.best_params
    # and the loaded study goes on, as tune --continue-study does
    loaded.optimize(lambda t: t.suggest_float("x", 0.0, 1.0), n_trials=1)
    assert len(loaded.trials) == 7
    assert reader.newest_study(str(tmp_path)) == path


def test_best_hp_from_the_trials_csv(tmp_path):
    import pandas as pd

    pd.DataFrame([dict(number=0, value=5.0, state="COMPLETE", params_lr=0.1),
                  dict(number=1, value=2.0, state="COMPLETE", params_lr=0.01)]).to_csv(
        tmp_path / "a_trials.csv", index=False)
    assert port_study.load_best_hp_from_csv(str(tmp_path)) == \
        jax_study.load_best_hp_from_csv(str(tmp_path)) == {"lr": 0.01, "value": 2.0}


# ---- the trial-parallel sweep ------------------------------------------------------


def tiny_batch(seed, b=2, n=128):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(b, n, 3)) * 3).astype(np.float32)
    feat = rng.normal(size=(b, n, 1)).astype(np.float32)
    mask = np.arange(n)[None] < np.asarray([n, n - 20])[:, None]
    y = rng.uniform(1, 30, size=(b, 4)).astype(np.float32)
    jb = JaxBatch(pos=jnp.asarray(pos), feat=jnp.asarray(feat), mask=jnp.asarray(mask),
                  y=jnp.asarray(y))
    tb = CloudBatch(pos=torch.from_numpy(pos), feat=torch.from_numpy(feat),
                    mask=torch.from_numpy(mask), y=torch.from_numpy(y))
    return jb, tb


def port_sweep(lrs, wds, **kwargs):
    return VmappedSweep(PointNet2Regressor(num_features=1), lrs, wds, device="cpu", **kwargs)


def adam_update(params, grads, lr, wd, adamw, dtype):
    """Three calls of the JAX package's ``_adam_update`` in ``dtype``."""
    jp = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    mu = {k: jnp.zeros_like(v) for k, v in jp.items()}
    nu = {k: jnp.zeros_like(v) for k, v in jp.items()}
    count = jnp.asarray(0, dtype)
    for g in grads:
        jp, mu, nu, count = jax_vmapped._adam_update(
            jp, {k: jnp.asarray(v, dtype) for k, v in g.items()}, mu, nu, count,
            jnp.asarray(lr, dtype), jnp.asarray(wd, dtype), adamw)
    return [{k: np.asarray(v, np.float64) for k, v in t.items()} for t in (jp, mu, nu)]


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW"])
@pytest.mark.parametrize("lr,wd", [(1e-3, 8.025e-5), (3e-2, 0.1)])
def test_the_trials_update_rule_is_adam_update(optimizer, lr, wd):
    """Three steps of a trial's optimizer on given gradients against the JAX
    package's ``_adam_update`` from the same parameters, evaluated in float64
    (rel <= 1e-6 for parameters and both moments). Evaluated in float32,
    ``_adam_update`` rounds its bias corrections: 1 - 0.999 in float32 is
    1.3e-5 off, which moves a step by up to 6.5e-6 of itself (torch computes
    them in float64), so that run is held only to 2e-5."""
    sweep = port_sweep([lr], [wd], optimizer=optimizer)
    trainer = sweep.init_states(seed=0)[0]
    named = dict(trainer.model.named_parameters())
    params = {k: p.detach().numpy().copy() for k, p in named.items()}
    rng = np.random.default_rng(1)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    with jax.enable_x64(True):
        exact = adam_update(params, grads, lr, wd, optimizer == "AdamW", jnp.float64)
    f32 = adam_update(params, grads, lr, wd, optimizer == "AdamW", jnp.float32)
    for g in grads:
        for k, p in named.items():
            p.grad = torch.from_numpy(g[k])
        trainer.optimizer.step()
    for k, p in named.items():
        st = trainer.optimizer.state[p]
        got = [t.detach().numpy() for t in (p, st["exp_avg"], st["exp_avg_sq"])]
        for name, a, want in zip(("param", "mu", "nu"), got, exact):
            assert rel_err(a, want[k]) <= ADAM_RTOL, (k, name)
        assert rel_err(got[0], f32[0][k]) <= ADAM_F32_RTOL, k


def test_the_eval_step_is_the_jax_eval_step_on_the_same_inits():
    """Each trial's eval loss on one batch against the vmapped ``_eval_step``,
    the JAX trials' initial variables carried into the port's trials."""
    jb, tb = tiny_batch(3)
    lrs, wds = [1e-3, 1e-2, 1e-4], [0.0, 1e-5, 1e-4]
    jsweep = jax_vmapped.VmappedSweep(JaxModel(num_features=1), lrs, wds)
    state = jsweep.init_states(jax.random.key(0), jb)
    want = np.asarray(jsweep._eval_step(state["params"], state["batch_stats"], jb))
    sweep = port_sweep(lrs, wds)
    sweep.init_states(seed=0)
    for i, trainer in enumerate(sweep.trials):
        v = jax.tree.map(lambda x: np.asarray(x[i]), {"params": state["params"],
                                                      "batch_stats": state["batch_stats"]})
        trainer.model.load_state_dict(from_flax_variables(v))
    got = sweep.evaluate([tb])
    assert got.shape == (3,) and np.isfinite(got).all()
    assert rel_err(got, want) <= F32_RTOL
    assert np.isnan(sweep.evaluate([tb], active=np.array([True, False, True]))[1])


class _Data:
    """A dataset of one batch, for the stubbed runs."""

    def batches(self, batch_size, **kwargs):
        yield "batch"


# per-epoch val MSEs of 3 trials; the early stopping acts on the rises
SCRIPTS = {
    "steady_fall": [[5, 4, 3], [4, 3, 2], [3, 2, 1], [2, 1, 0.5], [1, 0.5, 0.2]],
    "one_rises": [[5, 4, 3], [6, 3, 2], [7, 2, 1], [8, 1, 0.5], [9, 0.5, 0.2]],
    "rise_then_fall": [[5, 5, 5], [6, 4, 6], [5.5, 5, 7], [4, 6, 8], [3, 7, 9]],
    "all_stop": [[1, 1, 1], [2, 2, 2], [3, 3, 3], [4, 4, 4], [5, 5, 5]],
    "ties_do_not_rise": [[2, 2, 2], [2, 3, 2], [2, 2, 3], [2, 3, 3], [2, 4, 4]],
    "random": np.random.default_rng(5).uniform(1, 2, size=(5, 3)).tolist(),
}


def jax_stubbed_run(script, patience, early_stopping):
    jsweep = jax_vmapped.VmappedSweep(None, [1e-3] * 3, [0.0] * 3, patience=patience,
                                      early_stopping=early_stopping)
    actives, epoch = [], iter(range(len(script)))

    def train_step(state, lrs, wds, active, keys, batch):
        actives[-1] = np.asarray(active)
        return state, jnp.float32(0)

    def eval_step(params, bstats, batch):
        actives.append(None)  # the next epoch's train steps fill it
        return jnp.asarray(script[next(epoch)], jnp.float32)

    jsweep.init_states = lambda key, ex: {"params": None, "batch_stats": None}
    jsweep._train_step = train_step
    jsweep._eval_step = eval_step
    actives.append(None)
    res = jsweep.run(_Data(), _Data(), key=jax.random.key(0), batch_size=4,
                     num_epochs=len(script), log_fn=lambda s: None)
    return res, [a for a in actives if a is not None]


def port_stubbed_run(script, patience, early_stopping):
    sweep = VmappedSweep(PointNet2Regressor(num_features=1), [1e-3] * 3, [0.0] * 3,
                         patience=patience, early_stopping=early_stopping, device="cpu")
    steps, epoch = [], iter(range(len(script)))

    class Trial:
        def __init__(self, i):
            self.i = i

        def step(self, batch, generator):
            steps[-1][self.i] = True

    def init_states(seed):
        sweep.trials = [Trial(i) for i in range(3)]

    def validate(val_ds, batch_size, active):
        vals = np.asarray(script[next(epoch)], np.float32).astype(np.float64)
        return np.where(active, vals, np.nan)  # what a stopped trial's validation gives

    sweep.init_states = init_states
    sweep.trial_generator = lambda i, es: None
    sweep._validate = validate

    class Train(_Data):
        def batches(self, batch_size, **kwargs):
            steps.append(np.zeros(3, bool))
            yield "batch"

    res = sweep.run(Train(), _Data(), seed=0, batch_size=4, num_epochs=len(script),
                    log_fn=lambda s: None)
    return res, steps


@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("patience,early_stopping", [(1, True), (2, True), (1, False)])
def test_run_bookkeeping_is_the_jax_runs(name, patience, early_stopping):
    """best_val, epochs_run and stopped_early of every trial, and which trials
    train in each epoch, as in the JAX ``run`` (whose frozen trials are masked
    where the port's take no step)."""
    script = SCRIPTS[name]
    want, want_active = jax_stubbed_run(script, patience, early_stopping)
    got, got_steps = port_stubbed_run(script, patience, early_stopping)
    assert [(r.best_val_mse, r.epochs_run, r.stopped_early) for r in got] == \
        [(r.best_val_mse, r.epochs_run, r.stopped_early) for r in want]
    assert len(got_steps) == len(want_active)
    for stepped, active in zip(got_steps, want_active):
        np.testing.assert_array_equal(stepped, active)


@pytest.fixture(scope="module")
def tiny_data():
    pos, feat, y, ids = synthetic_dataset(8, 128, seed=0)
    ds = DeviceDataset.from_clouds(pos, feat, y, ids, base_n=128, device="cpu")
    pos, feat, y, ids = synthetic_dataset(4, 128, seed=1)
    val = DeviceDataset.from_clouds(pos, feat, y, ids, base_n=128, device="cpu")
    return ds, val


def state_of(trainer):
    model = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt = copy.deepcopy(trainer.optimizer.state_dict())
    return model, opt


def same_state(a, b) -> bool:
    (ma, oa), (mb, ob) = a, b
    if ma.keys() != mb.keys() or any(not torch.equal(ma[k], mb[k]) for k in ma):
        return False
    sa, sb = oa["state"], ob["state"]
    return sa.keys() == sb.keys() and all(
        torch.equal(sa[k][f], sb[k][f]) for k in sa for f in ("step", "exp_avg", "exp_avg_sq"))


def test_a_stopped_trial_keeps_its_state_and_a_trial_is_a_trainer_run(tiny_data):
    """3 epochs, patience 1, trial 1's val MSE made to rise at epoch 1: it
    stops there, and after the run its parameters, Adam moments and BatchNorm
    running statistics are those it had at the end of epoch 1, bit for bit.
    Trial 0 runs all 3 epochs, and its state equals a Trainer's over the same
    batches with the same generators from the same initial weights."""
    ds, val = tiny_data
    sweep = port_sweep([3e-3, 1e-3], [0.0, 8e-5], patience=1)
    init, snaps, epoch = {}, {}, iter(range(3))
    init_states, validate = sweep.init_states, sweep._validate

    def recorded_init(seed):
        trials = init_states(seed)
        init.update({i: state_of(t) for i, t in enumerate(trials)})
        return trials

    def scripted_validate(val_ds, batch_size, active):
        e = next(epoch)
        vals = validate(val_ds, batch_size, active)
        snaps[e] = state_of(sweep.trials[1])
        if e == 1:
            vals[1] = 1e9  # a rise: patience 1 stops trial 1 here
        return vals

    sweep.init_states, sweep._validate = recorded_init, scripted_validate
    res = sweep.run(ds, val, seed=11, batch_size=4, num_augs=1, num_epochs=3,
                    log_fn=lambda s: None)
    assert [(r.epochs_run, r.stopped_early) for r in res] == [(3, False), (2, True)]
    assert same_state(state_of(sweep.trials[1]), snaps[1])
    assert not same_state(snaps[0], snaps[1])  # it did train until it stopped

    ref = Trainer(PointNet2Regressor(num_features=1), sweep.trial_config(0), "cpu")
    ref.model.load_state_dict(init[0][0])
    for e in range(3):
        es = derive_seed(11, e)
        ref.train_epoch(ds.batches(4, seed=es, num_augs=1, shuffle=True),
                        sweep.trial_generator(0, es))
    assert same_state(state_of(ref), state_of(sweep.trials[0]))


def test_trials_draw_their_own_weights_and_streams():
    sweep = port_sweep([1e-3, 1e-3], [0.0, 0.0])
    a, b = sweep.init_states(seed=4)
    assert not torch.equal(a.model.sa1.mlp.lin0.weight, b.model.sa1.mlp.lin0.weight)
    again = sweep.init_states(seed=4)[1]
    assert torch.equal(again.model.sa1.mlp.lin0.weight, b.model.sa1.mlp.lin0.weight)
    g0, g1 = sweep.trial_generator(0, 99), sweep.trial_generator(1, 99)
    assert not torch.equal(torch.rand(4, generator=g0), torch.rand(4, generator=g1))


class _TwoRanks:
    """A stand-in for a mesh of two ranks: the trial split reads its size."""

    def size(self):
        return 2


@pytest.mark.parametrize("call", ["sweep", "grid_sweep"])
def test_trials_the_mesh_ranks_do_not_divide_are_refused(call, tiny_data):
    """The JAX package's rule and message (``vmapped.py:94-104``)."""
    with pytest.raises(ValueError, match="3 trials not divisible by 2 mesh devices"):
        if call == "sweep":
            port_sweep([1e-3, 1e-2, 1e-1], [0.0, 0.0, 0.0], mesh=_TwoRanks())
        else:
            grid_sweep(PointNet2Regressor(num_features=1), *tiny_data, lrs=[1e-3, 1e-2, 1e-1],
                       wds=[0.0], mesh=_TwoRanks(), device="cpu")


def test_grid_sweep_records_its_trials_in_a_study(tiny_data):
    study = port_study.create_study(study_name="grid")
    res = grid_sweep(PointNet2Regressor(num_features=1), *tiny_data, lrs=[1e-3, 1e-2],
                     wds=[0.0], batch_sizes=[4], num_epochs=1, study=study, seed=2,
                     log_fn=lambda s: None, device="cpu")
    assert len(res) == len(study.trials) == 2
    assert [t.params for t in study.trials] == [
        {"lr": 1e-3, "weight_decay": 0.0, "batch_size": 4, "num_augs": 0},
        {"lr": 1e-2, "weight_decay": 0.0, "batch_size": 4, "num_augs": 0}]
    assert all(np.isfinite(t.value) for t in study.trials)


# ---- the sequential objective --------------------------------------------------------


class _Built(Exception):
    """Raised where a trial would build its model: carries the config."""


@pytest.mark.parametrize("search", [True, False])
@pytest.mark.parametrize("sampler_seed", [0, 1, 2])
def test_the_objective_searches_the_jax_space_and_builds_the_same_config(
        search, sampler_seed, monkeypatch):
    import dl_biomass_tpu.models.pointnet2 as jax_pointnet2
    from dl_biomass_tpu.core.config import HyperParams as JaxHP
    from dl_biomass_tpu.core.config import TrainConfig as JaxCfg
    from dl_biomass_tpu_torch.core.config import HyperParams, TrainConfig

    def built(cfg, *args, **kwargs):
        raise _Built(cfg)

    monkeypatch.setattr(jax_pointnet2, "build_model", built)
    monkeypatch.setattr(port_pointnet2, "build_model", built)

    class Data:
        num_features = 1

    runs = []
    for mod, obj, cfg in ((jax_study, jax_objective, JaxCfg(hp=JaxHP(num_augs=2, lr=0.5))),
                          (port_study, port_objective,
                           TrainConfig(hp=HyperParams(num_augs=2, lr=0.5)))):
        cfg.model.fast_fps = False
        study = mod.create_study(sampler=mod.RandomSampler(sampler_seed))
        trial = mod.Trial(study, mod.FrozenTrial(number=0))
        objective = obj.make_training_objective(Data(), Data(), base_cfg=cfg, max_num_epochs=7,
                                                search_batch_and_augs=search)
        with pytest.raises(_Built) as e:
            objective(trial)
        specs = {k: dataclasses.astuple(v) for k, v in trial._frozen.distributions.items()}
        runs.append((trial.params, specs, json.dumps(e.value.args[0].to_dict(), sort_keys=True)))
    assert runs[0] == runs[1]
    assert ("num_augs" in runs[1][0]) == search

