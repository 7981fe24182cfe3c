"""Evaluation metrics + results-frame construction (copied from
``dl_biomass_tpu/eval/metrics.py``).

Parity with the reference's ``testing_model.py:70-100``: an obs/pred dataframe
per biomass component with summed total-tree columns and residuals, and an
r2/rmse/mape metrics table (sklearn definitions, computed directly in numpy so
the eval path has no sklearn dependency).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import pandas as pd

COMPONENTS = ("bark_btphr", "branch_btphr", "foliage_btphr", "wood_btphr")
ALL_ROWS = ("wood_btphr", "bark_btphr", "branch_btphr", "foliage_btphr", "tree_btphr")


def r2_score(obs: np.ndarray, pred: np.ndarray) -> float:
    obs = np.asarray(obs, np.float64)
    pred = np.asarray(pred, np.float64)
    ss_res = np.sum((obs - pred) ** 2)
    ss_tot = np.sum((obs - obs.mean()) ** 2)
    return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0

def rmse(obs: np.ndarray, pred: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(obs, np.float64) - pred) ** 2)))


def mape(obs: np.ndarray, pred: np.ndarray) -> float:
    """sklearn mean_absolute_percentage_error: |err|/max(|obs|, eps)."""
    obs = np.asarray(obs, np.float64)
    pred = np.asarray(pred, np.float64)
    denom = np.maximum(np.abs(obs), np.finfo(np.float64).eps)
    return float(np.mean(np.abs(obs - pred) / denom))


def build_results_frame(
    obs: np.ndarray, pred: np.ndarray, plot_ids: Sequence[str]
) -> pd.DataFrame:
    """obs/pred (P, 4) -> dataframe with per-component obs/pred/resid columns,
    total-tree sums, and the dataset source (+plot colour) used by the figure
    suite (reference ``testing_model.py:70-114``)."""
    cols = [f"{c}_obs" for c in COMPONENTS] + [f"{c}_pred" for c in COMPONENTS]
    df = pd.DataFrame(
        np.concatenate([obs, pred], axis=1), columns=cols, index=list(plot_ids)
    )
    df["tree_btphr_obs"] = sum(df[f"{c}_obs"] for c in COMPONENTS)
    df["tree_btphr_pred"] = sum(df[f"{c}_pred"] for c in COMPONENTS)
    for c in ALL_ROWS:
        df[f"{c}_resid"] = df[f"{c}_obs"] - df[f"{c}_pred"]
    df["dataset"] = [str(i)[:2] for i in df.index]
    colour = {"BC": "red", "PF": "blue"}
    df["colour"] = [colour.get(d, "green") for d in df["dataset"]]
    return df


def metrics_table(df: pd.DataFrame) -> pd.DataFrame:
    """r2/rmse/mape per component + total tree, rounded like the reference
    (``testing_model.py:91-98``: r2/rmse to 2 decimals, mape to 3)."""
    out = pd.DataFrame(columns=["r2", "rmse", "mape"], index=list(ALL_ROWS))
    for comp in ALL_ROWS:
        o, p = df[f"{comp}_obs"], df[f"{comp}_pred"]
        out.loc[comp, "r2"] = round(r2_score(o, p), 2)
        out.loc[comp, "rmse"] = round(rmse(o, p), 2)
        out.loc[comp, "mape"] = round(mape(o, p), 3)
    return out
