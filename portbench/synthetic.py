"""Synthetic forest-plot generator: a copy of ``dl_biomass_tpu_torch/io/synthetic.py``.

The reference's LAS plots (BC Gov / Romeo-Malette / Petawawa) are not shipped with
the repo, so tests and benchmarks use procedurally generated plots with the same
statistical shape: ~11.3 m radius circular plots, cone-shaped tree crowns over a
ground layer, intensity per return, and 4-component biomass targets that are a
noisy function of canopy structure (so models can genuinely learn).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

PLOT_RADIUS = 11.3  # ~400 m^2 circular plot


def synthetic_plot(
    rng: np.random.Generator, n_points: int, plot_radius: float = PLOT_RADIUS
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One plot: returns (coords (N,3) float64, intensity (N,) uint16-like,
    biomass (4,) [bark, branch, foliage, wood] tons/ha)."""
    n_trees = int(rng.integers(4, 25))
    tx = rng.uniform(-plot_radius, plot_radius, n_trees)
    ty = rng.uniform(-plot_radius, plot_radius, n_trees)
    th = rng.uniform(5.0, 30.0, n_trees)  # tree heights
    tr = th * rng.uniform(0.08, 0.18, n_trees)  # crown radii

    n_ground = max(n_points // 5, 1)
    n_canopy = n_points - n_ground

    # canopy points on cones
    tree_of = rng.integers(0, n_trees, n_canopy)
    u = rng.uniform(0, 1, n_canopy) ** 0.5  # denser near crown top
    z = th[tree_of] * (1 - u * rng.uniform(0.2, 1.0, n_canopy))
    frac = 1 - z / np.maximum(th[tree_of], 1e-6)
    rad = tr[tree_of] * frac * np.sqrt(rng.uniform(0, 1, n_canopy))
    ang = rng.uniform(0, 2 * np.pi, n_canopy)
    cx = tx[tree_of] + rad * np.cos(ang)
    cy = ty[tree_of] + rad * np.sin(ang)
    canopy = np.stack([cx, cy, np.maximum(z, 0.0)], 1)

    # ground layer
    ga = rng.uniform(0, 2 * np.pi, n_ground)
    gr = plot_radius * np.sqrt(rng.uniform(0, 1, n_ground))
    ground = np.stack(
        [gr * np.cos(ga), gr * np.sin(ga), np.abs(rng.normal(0, 0.05, n_ground))], 1
    )

    coords = np.concatenate([canopy, ground], 0)
    perm = rng.permutation(n_points)
    coords = coords[perm]

    # intensity: canopy returns brighter, ground darker + noise (raw uint16 range)
    is_canopy = (perm < n_canopy).astype(np.float64)
    intensity = np.clip(
        12000 * is_canopy + 4000 + rng.normal(0, 2000, n_points), 0, 65535
    )

    # biomass: deterministic function of stand structure + noise; proportions
    # roughly match the reference's dataset-wide shares (main.py:163-166 comments)
    stand_volume = float(np.sum(th**2.2 * tr)) / 80.0
    total = stand_volume * rng.uniform(0.9, 1.1)
    shares = np.array([0.11, 0.12, 0.05, 0.72])
    shares = shares * rng.uniform(0.85, 1.15, 4)
    shares /= shares.sum()
    biomass = (total * shares).astype(np.float64)

    return coords, intensity, biomass


def synthetic_dataset(
    num_plots: int,
    n_points: int,
    seed: int = 0,
    sources: Sequence[str] = ("BC", "RM", "PF"),
) -> Tuple[List[np.ndarray], List[np.ndarray], np.ndarray, List[str]]:
    """A list of plots with normalized-intensity features and dataset-prefixed
    PlotIDs (the reference derives the source from the first two filename chars,
    ``pointcloud_dataloader.py:67-75``)."""
    rng = np.random.default_rng(seed)
    pos_list, feat_list, ids = [], [], []
    ys = np.zeros((num_plots, 4), np.float32)
    for i in range(num_plots):
        coords, intensity, biomass = synthetic_plot(rng, n_points)
        coords = coords - coords.mean(axis=0)
        lo, hi = intensity.min(), intensity.max()
        i_norm = (intensity - lo) / max(hi - lo, 1e-9) * 20  # x20 (reference quirk)
        pos_list.append(coords.astype(np.float32))
        feat_list.append(i_norm.astype(np.float32).reshape(-1, 1))
        ys[i] = biomass
        src = sources[i % len(sources)]
        ids.append(f"{src}_{i:04d}")
    return pos_list, feat_list, ys, ids
