"""Hyperparameter study API — an Optuna-compatible surface (copied from
``dl_biomass_tpu/sweep/study.py``, which imports no JAX; a study either package
saves loads in the other).

The reference drives a 4-day Optuna TPE study with a median-style pruner, pickle
persistence/resume, a trials dataframe export, and a param-importance bar chart
(``hyperparameter_tuning.py:26-351``). This module provides that surface without
the optuna dependency:

  * ``create_study(direction, sampler)`` / ``study.optimize(objective, ...)``
    with ``trial.suggest_float/int/categorical``, ``trial.report`` +
    ``trial.should_prune`` and the ``TrialPruned`` exception;
  * samplers: TPE (univariate Parzen estimators, Optuna's default strategy),
    random, and grid;
  * ``MedianPruner`` (prune when the intermediate value is worse than the median
    of completed trials at the same step);
  * JSON persistence (``study.save`` / ``load_study``) replacing joblib pickles
    (``hyperparameter_tuning.py:233-254``), ``trials_dataframe()``
    (``:289-294``), and ``get_param_importances`` (``:276-286``).

For the trial-parallel grid, see ``sweep/vmapped.py`` — this sequential API
is the compatibility layer.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class TrialPruned(Exception):
    """Raised inside an objective to abort a hopeless trial."""


class TrialState(str, Enum):
    RUNNING = "RUNNING"
    COMPLETE = "COMPLETE"
    PRUNED = "PRUNED"
    FAIL = "FAIL"


@dataclass
class _ParamSpec:
    kind: str  # float | int | categorical
    low: float = 0.0
    high: float = 0.0
    step: Optional[float] = None
    log: bool = False
    choices: Sequence[Any] = ()


@dataclass
class FrozenTrial:
    number: int
    params: Dict[str, Any] = field(default_factory=dict)
    distributions: Dict[str, _ParamSpec] = field(default_factory=dict)
    intermediate_values: Dict[int, float] = field(default_factory=dict)
    value: Optional[float] = None
    state: TrialState = TrialState.RUNNING


class Trial:
    """Live trial handle passed to the objective."""

    def __init__(self, study: "Study", frozen: FrozenTrial):
        self._study = study
        self._frozen = frozen

    @property
    def number(self) -> int:
        return self._frozen.number

    @property
    def params(self) -> Dict[str, Any]:
        return dict(self._frozen.params)

    def _suggest(self, name: str, spec: _ParamSpec):
        if name in self._frozen.params:
            return self._frozen.params[name]
        value = self._study.sampler.sample(self._study, name, spec)
        self._frozen.params[name] = value
        self._frozen.distributions[name] = spec
        return value

    def suggest_float(self, name, low, high, *, step=None, log=False) -> float:
        return float(self._suggest(name, _ParamSpec("float", low, high, step, log)))

    def suggest_int(self, name, low, high, step=1, log=False) -> int:
        return int(self._suggest(name, _ParamSpec("int", low, high, step, log)))

    def suggest_categorical(self, name, choices):
        return self._suggest(name, _ParamSpec("categorical", choices=list(choices)))

    def report(self, value: float, step: int) -> None:
        self._frozen.intermediate_values[int(step)] = float(value)

    def should_prune(self) -> bool:
        p = self._study.pruner
        return bool(p and p.prune(self._study, self._frozen))


# ---- samplers --------------------------------------------------------------------


class RandomSampler:
    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def _unit(self) -> float:
        return float(self.rng.random())

    def sample(self, study: "Study", name: str, spec: _ParamSpec):
        return _from_unit(spec, self._unit(), self.rng)


class TPESampler(RandomSampler):
    """Univariate Parzen-estimator sampler (Optuna's default strategy).

    For each parameter: split past completed trials into the best ``gamma``
    fraction and the rest, fit Gaussian KDEs l(x) and g(x) in the transformed
    (log/linear) space, draw candidates from l and keep the one maximizing
    l(x)/g(x)."""

    def __init__(self, seed: int = 0, n_startup_trials: int = 10,
                 n_candidates: int = 24, gamma: float = 0.25):
        super().__init__(seed)
        self.n_startup_trials = n_startup_trials
        self.n_candidates = n_candidates
        self.gamma = gamma

    def sample(self, study: "Study", name: str, spec: _ParamSpec):
        done = [t for t in study.trials
                if t.state == TrialState.COMPLETE and name in t.params and t.value is not None]
        if len(done) < self.n_startup_trials or spec.kind == "categorical":
            if spec.kind == "categorical" and len(done) >= self.n_startup_trials:
                return self._sample_categorical(done, spec, name, study.direction)
            return _from_unit(spec, self._unit(), self.rng)

        vals = np.asarray([t.value for t in done], float)
        order = np.argsort(vals if study.direction == "minimize" else -vals)
        n_good = max(1, int(math.ceil(self.gamma * len(done))))
        xs = np.asarray([_to_space(t.params[name], spec) for t in done], float)
        good, bad = xs[order[:n_good]], xs[order[n_good:]]
        if len(bad) == 0:
            bad = xs

        lo, hi = _space_bounds(spec)
        span = hi - lo
        bw_g = max(span / max(len(good), 1) * 1.06, 1e-12)
        bw_b = max(span / max(len(bad), 1) * 1.06, 1e-12)

        cand = self.rng.choice(good, size=self.n_candidates) + self.rng.normal(
            0, bw_g, self.n_candidates
        )
        cand = np.clip(cand, lo, hi)

        def kde(pts, bw, x):
            z = (x[:, None] - pts[None, :]) / bw
            return np.exp(-0.5 * z * z).sum(axis=1) / (len(pts) * bw) + 1e-300

        score = kde(good, bw_g, cand) / kde(bad, bw_b, cand)
        return _from_space(float(cand[int(np.argmax(score))]), spec)

    def _sample_categorical(self, done, spec, name, direction):
        vals = np.asarray([t.value for t in done], float)
        order = np.argsort(vals if direction == "minimize" else -vals)
        n_good = max(1, int(math.ceil(self.gamma * len(done))))
        good = [done[i].params[name] for i in order[:n_good]]
        # weighted toward choices that appear among good trials
        weights = np.asarray([1.0 + 3.0 * good.count(c) for c in spec.choices])
        weights /= weights.sum()
        return spec.choices[int(self.rng.choice(len(spec.choices), p=weights))]


class GridSampler:
    """Exhaustive grid over explicit per-param value lists."""

    def __init__(self, search_space: Dict[str, Sequence[Any]]):
        self.space = {k: list(v) for k, v in search_space.items()}
        names = list(self.space)
        from itertools import product

        self._grid = [dict(zip(names, combo)) for combo in product(*self.space.values())]
        # grid points are assigned per trial SEEN BY THIS SAMPLER, not by the
        # study's absolute trial number — a study resumed with prior trials
        # from another sampler must still walk the whole grid
        self._assigned: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._grid)

    def is_exhausted(self) -> bool:
        """True once every grid point has been assigned to a trial (a failed
        trial consumes its point; Study.optimize stops instead of re-running
        duplicates)."""
        return len(self._assigned) >= len(self._grid)

    def sample(self, study: "Study", name: str, spec: _ParamSpec):
        num = study._current_trial_number
        if num not in self._assigned:
            self._assigned[num] = len(self._assigned) % len(self._grid)
        return self._grid[self._assigned[num]][name]


def _to_space(v, spec: _ParamSpec) -> float:
    return math.log(v) if spec.log else float(v)


def _from_space(x: float, spec: _ParamSpec):
    v = math.exp(x) if spec.log else x
    if spec.step:
        v = spec.low + round((v - spec.low) / spec.step) * spec.step
    v = min(max(v, spec.low), spec.high)
    return int(round(v)) if spec.kind == "int" else float(v)


def _space_bounds(spec: _ParamSpec):
    return (_to_space(spec.low, spec), _to_space(spec.high, spec))


def _from_unit(spec: _ParamSpec, u: float, rng) -> Any:
    if spec.kind == "categorical":
        return spec.choices[int(u * len(spec.choices)) % len(spec.choices)]
    lo, hi = _space_bounds(spec)
    return _from_space(lo + u * (hi - lo), spec)


# ---- pruner ---------------------------------------------------------------------


class MedianPruner:
    """Prune when the intermediate value is worse than the median of completed
    trials' values at the same step (reference uses Optuna's default pruner,
    ``hyperparameter_tuning.py:223-225``)."""

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps

    def prune(self, study: "Study", frozen: FrozenTrial) -> bool:
        if not frozen.intermediate_values:
            return False
        step = max(frozen.intermediate_values)
        if step < self.n_warmup_steps:
            return False
        done = [t for t in study.trials if t.state == TrialState.COMPLETE]
        if len(done) < self.n_startup_trials:
            return False
        # "best so far" follows the study direction — min() under maximize
        # would judge every trial by its WORST epoch and prune improving runs
        best = min if study.direction == "minimize" else max
        peers = [
            best(v for s, v in t.intermediate_values.items() if s <= step)
            for t in done
            if t.intermediate_values and min(t.intermediate_values) <= step
        ]
        if not peers:
            return False
        median = float(np.median(peers))
        current = best(v for s, v in frozen.intermediate_values.items() if s <= step)
        return current > median if study.direction == "minimize" else current < median


# ---- study ----------------------------------------------------------------------


_DEFAULT_PRUNER = object()  # unique sentinel: pruner=None must mean NO pruning


class Study:
    def __init__(self, direction: str = "minimize", sampler=None,
                 pruner=_DEFAULT_PRUNER, study_name: str = "study"):
        if direction not in ("minimize", "maximize"):
            raise ValueError(f"direction {direction!r}")
        self.direction = direction
        self.sampler = sampler or TPESampler()
        # pruner=None disables pruning (Optuna's NopPruner analog); only the
        # not-given default gets the MedianPruner
        self.pruner = MedianPruner() if pruner is _DEFAULT_PRUNER else pruner
        self.study_name = study_name
        self.trials: List[FrozenTrial] = []
        self._current_trial_number = 0

    # -- optimize ------------------------------------------------------------

    def optimize(
        self,
        objective: Callable[[Trial], float],
        n_trials: Optional[int] = None,
        timeout: Optional[float] = None,
        callbacks: Sequence[Callable] = (),
        show_progress_bar: bool = False,
        catch: tuple = (),
    ) -> None:
        """Optuna-compatible optimize loop. ``catch``: exception types that
        mark the trial FAILED and continue the study instead of raising —
        Optuna's own ``catch`` semantics. Use e.g. ``catch=(Exception,)`` to
        survive environment-level failures (a TPU worker crash costs one
        trial, not the whole study; see the known b=28 x 7168-pt eval fault
        in docs/DESIGN.md)."""
        start = time.time()
        i = 0
        while True:
            if n_trials is not None and i >= n_trials:
                break
            if timeout is not None and time.time() - start > timeout:
                break
            if n_trials is None and timeout is None and i >= 1:
                break
            # a finite sampler (GridSampler) stops when its grid is exhausted
            # instead of silently re-running duplicate configurations
            if getattr(self.sampler, "is_exhausted", lambda: False)():
                break
            frozen = FrozenTrial(number=len(self.trials))
            self._current_trial_number = frozen.number
            self.trials.append(frozen)
            trial = Trial(self, frozen)
            try:
                value = objective(trial)
                frozen.value = float(value)
                frozen.state = TrialState.COMPLETE
            except TrialPruned:
                frozen.state = TrialState.PRUNED
                if frozen.intermediate_values:
                    best = min if self.direction == "minimize" else max
                    frozen.value = best(frozen.intermediate_values.values())
            except catch as e:  # noqa: E722 - Optuna catch semantics
                frozen.state = TrialState.FAIL
                import sys as _sys
                print(f"[study] trial {frozen.number} FAILED "
                      f"({type(e).__name__}: {e}); continuing", file=_sys.stderr)
            except Exception:
                frozen.state = TrialState.FAIL
                raise
            for cb in callbacks:
                cb(self, frozen)
            i += 1

    # -- results ---------------------------------------------------------------

    @property
    def best_trial(self) -> FrozenTrial:
        done = [t for t in self.trials if t.state == TrialState.COMPLETE]
        if not done:
            raise ValueError("no completed trials")
        key = (lambda t: t.value) if self.direction == "minimize" else (lambda t: -t.value)
        return min(done, key=key)

    @property
    def best_value(self) -> float:
        return self.best_trial.value

    @property
    def best_params(self) -> Dict[str, Any]:
        return dict(self.best_trial.params)

    def get_trials(self, deepcopy: bool = False, states: Optional[Sequence[TrialState]] = None):
        ts = self.trials
        if states is not None:
            ts = [t for t in ts if t.state in states]
        return list(ts)

    def trials_dataframe(self):
        import pandas as pd

        rows = []
        for t in self.trials:
            row = {"number": t.number, "value": t.value, "state": t.state.value}
            row.update({f"params_{k}": v for k, v in t.params.items()})
            rows.append(row)
        return pd.DataFrame(rows)

    def get_param_importances(self) -> Dict[str, float]:
        """Random-forest importances over params -> value (replaces
        ``optuna.importance.get_param_importances``)."""
        done = [t for t in self.trials if t.state == TrialState.COMPLETE]
        names = sorted({k for t in done for k in t.params})
        if len(done) < 4 or not names:
            return {n: 1.0 / max(len(names), 1) for n in names}
        from sklearn.ensemble import RandomForestRegressor

        cats = {n for t in done for n, s in t.distributions.items() if s.kind == "categorical"}
        # stable per-study categorical encoding: index into the sorted value
        # set (python's hash() is process-salted — importances from the same
        # study JSON would differ across runs)
        cat_codes = {
            n: {v: k for k, v in enumerate(sorted({str(t.params.get(n, 0)) for t in done}))}
            for n in cats
        }
        x = np.zeros((len(done), len(names)))
        for i, t in enumerate(done):
            for j, n in enumerate(names):
                v = t.params.get(n, 0)
                x[i, j] = cat_codes[n][str(v)] if n in cats else float(v)
        y = np.asarray([t.value for t in done])
        rf = RandomForestRegressor(n_estimators=64, random_state=0).fit(x, y)
        imp = rf.feature_importances_
        total = imp.sum() or 1.0
        return {n: float(v / total) for n, v in sorted(zip(names, imp), key=lambda kv: -kv[1])}

    # -- persistence -------------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        payload = {
            "study_name": self.study_name,
            "direction": self.direction,
            "trials": [
                {
                    "number": t.number,
                    "params": t.params,
                    "value": t.value,
                    "state": t.state.value,
                    "intermediate_values": t.intermediate_values,
                }
                for t in self.trials
            ],
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)


def create_study(direction: str = "minimize", sampler=None,
                 pruner=_DEFAULT_PRUNER, study_name: str = "study") -> Study:
    return Study(direction=direction, sampler=sampler, pruner=pruner, study_name=study_name)


def load_study(path: str, sampler=None, pruner=_DEFAULT_PRUNER) -> Study:
    with open(path) as f:
        payload = json.load(f)
    s = Study(direction=payload["direction"], sampler=sampler, pruner=pruner,
              study_name=payload.get("study_name", "study"))
    for t in payload["trials"]:
        s.trials.append(
            FrozenTrial(
                number=t["number"],
                params=t["params"],
                value=t["value"],
                state=TrialState(t["state"]),
                intermediate_values={int(k): v for k, v in t["intermediate_values"].items()},
            )
        )
    return s


def newest_study(folder: str, glob_pat: str = "*.json") -> Optional[str]:
    """Newest study file by mtime (the reference resumes the newest .pkl —
    ``hyperparameter_tuning.py:233-241``)."""
    import glob as _glob

    files = _glob.glob(os.path.join(folder, glob_pat))
    return max(files, key=os.path.getmtime) if files else None


def load_best_hp_from_csv(folder: str, glob_pat: str = "*_trials.csv") -> dict:
    """Best hyperparameters from the newest trials CSV in ``folder``.

    Parity with the reference's trainer variant that boots from the newest
    tuning-results CSV sorted by value (``Misc/main_V3.py:19-29``). Returns the
    best row's params as a plain dict (keys without the ``params_`` prefix).
    """
    import glob as _glob

    import pandas as pd

    files = _glob.glob(os.path.join(folder, glob_pat))
    if not files:
        raise FileNotFoundError(f"no trials CSVs matching {glob_pat!r} under {folder!r}")
    newest = max(files, key=os.path.getmtime)
    df = pd.read_csv(newest)
    df = df[df["value"].notna()].sort_values(by="value", ascending=True)
    if df.empty:
        raise ValueError(f"{newest}: no completed trials")
    row = df.iloc[0].to_dict()
    return {
        k.replace("params_", ""): v
        for k, v in row.items()
        if k.startswith("params_")
    } | {"value": row["value"]}
