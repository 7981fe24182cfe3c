"""Host-side (numpy) augmentation — exact reference semantics (a copy of
``dl_biomass_tpu/transforms/numpy_augment.py``, which is framework-free; the
port imports nothing of the JAX package).

These mirror ``augmentation.py:54-122`` of the reference 1:1 (same sampling
distributions, same compaction behavior) for the host pipeline and as the
cross-check oracle for the on-device transforms in ``transforms/augment.py``.
The on-device versions are the production path (masked, static shapes); these
produce variable-size arrays exactly like the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def rotate_points(rng: np.random.Generator, coords: np.ndarray) -> np.ndarray:
    """Uniform z-rotation in (-180, 180) degrees (``augmentation.py:54-70``)."""
    rotation = np.radians(rng.uniform(-180, 180))
    rot_mat = np.array(
        [
            [np.cos(rotation), -np.sin(rotation), 0],
            [np.sin(rotation), np.cos(rotation), 0],
            [0, 0, 1],
        ]
    )
    out = coords.copy()
    out[:, :3] = out[:, :3] @ rot_mat
    return out


def point_removal(
    rng: np.random.Generator, coords: np.ndarray, x: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Keep a uniform-random subset of size U[round(0.9n), n]
    (``augmentation.py:73-88``)."""
    n = coords.shape[0]
    keep = rng.integers(round(n * 0.9), n + 1)
    idx = rng.choice(n, keep, replace=False)
    aug_coords = coords[idx]
    aug_x = aug_coords if x is None else x[idx]
    return aug_coords, aug_x


def random_noise(
    rng: np.random.Generator,
    coords: np.ndarray,
    dim: int,
    x: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Jitter with sigma ~ U(0.01, 0.025), 50/50 add/subtract, then append up to
    10% duplicated noisy points (``augmentation.py:91-122``)."""
    sd = rng.uniform(0.01, 0.025)
    sign = 1.0 if rng.uniform(0, 1) >= 0.5 else -1.0
    aug_coords = coords + sign * rng.normal(0, sd, size=(coords.shape[0], 3))
    aug_x = aug_coords if x is None else x + sign * rng.normal(0, sd, size=(x.shape[0], dim))

    n_extra = rng.integers(0, round(len(aug_coords) * 0.1) + 1)
    use_idx = rng.choice(aug_coords.shape[0], n_extra, replace=False)
    out_coords = np.append(coords, aug_coords[use_idx], axis=0)
    base_x = coords if x is None else x
    out_x = np.append(base_x, aug_x[use_idx], axis=0)
    return out_coords, out_x


def augment(
    rng: np.random.Generator, coords: np.ndarray, x: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Full reference chain: removal -> noise-append -> rotation
    (``augmentation.py:278-280``)."""
    dim = 0 if x is None else x.shape[1]
    coords, x = point_removal(rng, coords, x)
    coords, x = random_noise(rng, coords, dim, x)
    coords = rotate_points(rng, coords)
    return coords, x
