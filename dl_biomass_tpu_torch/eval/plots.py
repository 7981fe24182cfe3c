"""Figure suite for model evaluation (reference ``testing_model.py:102-330``);
copied from ``dl_biomass_tpu/eval/plots.py``.

Four figure families, saved as PNG: total-tree obs-vs-pred, total-tree
residuals, 2x2 per-component obs-vs-pred, 2x2 per-component residuals — points
coloured by dataset source (BC=red, PF=blue, RM=green) — plus the optional
3-D point-cloud grid of four random plots and the train/val MSE curve
(reference ``main.py:255-273``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.patches as mpatches
import matplotlib.pyplot as plt
import numpy as np
import pandas as pd

_LEGEND = (("red", "BC Gov"), ("blue", "Petawawa"), ("green", "Romeo-Malette"))


def _legend_handles():
    return [mpatches.Patch(color=c, label=l) for c, l in _LEGEND]


def _stats_text(metrics_df: pd.DataFrame, comp: str) -> str:
    return (
        f"R2: {metrics_df.loc[comp, 'r2']}\nRMSE: {metrics_df.loc[comp, 'rmse']}"
        f"\nMAPE: {round(metrics_df.loc[comp, 'mape'], 2)}"
    )


def plot_total_obs_vs_pred(df, metrics_df, out_path: Optional[str] = None):
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(1, 1, 1)
    ax.scatter(df["tree_btphr_obs"], df["tree_btphr_pred"], alpha=0.8,
               c=df["colour"], edgecolors="none", s=30)
    plt.figtext(0.05, 0.9, _stats_text(metrics_df, "tree_btphr"),
                horizontalalignment="left", verticalalignment="center",
                transform=ax.transAxes)
    plt.legend(handles=_legend_handles(), loc="lower right")
    plt.title("Total Tree AGB Observed vs Predicted", loc="center", fontsize=15)
    plt.axis("scaled")
    if out_path:
        plt.savefig(out_path)
    plt.close(fig)


def plot_total_residuals(df, out_path: Optional[str] = None):
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(1, 1, 1)
    ax.scatter(df["tree_btphr_obs"], df["tree_btphr_resid"], alpha=0.8,
               c=df["colour"], edgecolors="none", s=30)
    plt.legend(handles=_legend_handles(), loc="lower right")
    plt.title("Total Tree AGB Residuals", loc="center", fontsize=15)
    plt.axis("scaled")
    if out_path:
        plt.savefig(out_path)
    plt.close(fig)


_GRID = [("bark_btphr", 0, 0, "Bark"), ("branch_btphr", 1, 0, "Branch"),
         ("foliage_btphr", 0, 1, "Foliage"), ("wood_btphr", 1, 1, "Wood")]


def plot_component_obs_vs_pred(df, metrics_df, out_path: Optional[str] = None):
    fig, ax = plt.subplots(2, 2, figsize=(10, 10))
    fig.suptitle("Component Biomass Observed vs Predicted", fontsize=15)
    for comp, r, c, title in _GRID:
        ax[r, c].scatter(df[f"{comp}_obs"], df[f"{comp}_pred"], alpha=0.8,
                         c=df["colour"], edgecolors="none", s=30)
        ax[r, c].title.set_text(title)
        ax[r, c].text(0.1, 0.9, _stats_text(metrics_df, comp),
                      horizontalalignment="left", verticalalignment="top",
                      transform=ax[r, c].transAxes)
    for axis in ax.flat:
        axis.set(xlabel="Observed Biomass (tons)", ylabel="Predicted Biomass (tons)")
    plt.subplots_adjust(left=0.1, bottom=0.1, right=0.9, top=0.9, wspace=0.3, hspace=0.3)
    plt.legend(handles=_legend_handles(), loc="lower right")
    if out_path:
        plt.savefig(out_path)
    plt.close(fig)


def plot_component_residuals(df, out_path: Optional[str] = None):
    fig, ax = plt.subplots(2, 2, figsize=(10, 10))
    fig.suptitle("Component Biomass Residuals", fontsize=15)
    for comp, r, c, title in _GRID:
        ax[r, c].scatter(df[f"{comp}_obs"], df[f"{comp}_resid"], alpha=0.8,
                         c=df["colour"], edgecolors="none", s=30)
        ax[r, c].title.set_text(title)
    for axis in ax.flat:
        axis.set(xlabel="Observed Biomass (tons)", ylabel="Residuals (tons)")
    plt.subplots_adjust(left=0.1, bottom=0.1, right=0.9, top=0.9, wspace=0.3, hspace=0.3)
    plt.legend(handles=_legend_handles(), loc="lower right")
    if out_path:
        plt.savefig(out_path)
    plt.close(fig)


def plot_cloud_grid(coords_list: Sequence[np.ndarray], out_path: Optional[str] = None):
    """2x2 grid of 3-D scatter renders, height-coloured (reference
    ``testing_model.py:307-330``, ``downsampling_point_clouds.py:217-240``)."""
    fig = plt.figure(figsize=[30, 30])
    for i, coords in enumerate(coords_list[:4]):
        ax = fig.add_subplot(2, 2, i + 1, projection="3d")
        ax.scatter(coords[:, 0], coords[:, 1], coords[:, 2], c=coords[:, 2],
                   cmap="viridis", linewidth=0.5)
    if out_path:
        plt.savefig(out_path)
    plt.close(fig)


def plot_param_importances(importances, out_path: Optional[str] = None):
    """Horizontal bar chart of hyperparameter importances (reference
    ``hyperparameter_tuning.py:276-286``, optuna's plot_param_importances)."""
    names = list(importances.keys())[::-1]  # most important on top
    vals = [importances[n] for n in names]
    fig, ax = plt.subplots(figsize=(8, max(2, 0.6 * len(names) + 1)))
    ax.barh(names, vals, color="tab:blue")
    for i, v in enumerate(vals):
        ax.text(v, i, f" {v:.3f}", va="center")
    ax.set_xlabel("Importance for objective value")
    ax.set_title("Hyperparameter Importances")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
        return out_path
    return fig


def plot_mse_curves(csv_path: str, out_path: Optional[str] = None):
    """Train/val MSE curve from the trainer's CSV log (reference ``main.py:255-273``)."""
    df = pd.read_csv(csv_path, sep=",", header=None)
    df.columns = ["epoch", "train_mse", "val_mse"]
    fig, ax = plt.subplots()
    ax.plot(df["epoch"], df["train_mse"], color="blue", marker="o")
    ax.plot(df["epoch"], df["val_mse"], color="red", marker="o")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("MSE")
    plt.legend(handles=[mpatches.Patch(color="red", label="Validation"),
                        mpatches.Patch(color="blue", label="Training")])
    if out_path:
        plt.savefig(out_path)
    plt.close(fig)


def save_all_eval_figures(df, metrics_df, fig_out_dir: str) -> List[str]:
    os.makedirs(fig_out_dir, exist_ok=True)
    paths = {
        "tree_btphr_obs_vs_pred.png": lambda p: plot_total_obs_vs_pred(df, metrics_df, p),
        "tree_btphr_residuals.png": lambda p: plot_total_residuals(df, p),
        "component_obs_vs_pred.png": lambda p: plot_component_obs_vs_pred(df, metrics_df, p),
        "component_residuals.png": lambda p: plot_component_residuals(df, p),
    }
    out = []
    for name, fn in paths.items():
        p = os.path.join(fig_out_dir, name)
        fn(p)
        out.append(p)
    return out
