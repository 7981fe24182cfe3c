"""Slow, obviously-correct numpy oracles: ``fps_numpy`` and ``ball_query_numpy``
copied from ``dl_biomass_tpu/ops/reference.py``.

These mirror the *semantics* of the reference's native ops (torch_cluster
fps/radius, torch_scatter max) as plain Python loops. ``fps_numpy`` is the
offline resampler's ``numpy`` engine (``io/resample.py``) and the native
library's stand-in when it cannot be built (``native/pointops.py``).
"""

from __future__ import annotations

import numpy as np


def fps_numpy(pos: np.ndarray, mask: np.ndarray, k: int, start: int) -> np.ndarray:
    """Iterative max-min farthest point sampling over valid points only."""
    n = pos.shape[0]
    dists = np.where(mask, np.inf, -np.inf).astype(np.float64)
    out = np.zeros(k, np.int32)
    out[0] = start
    last = start
    for i in range(1, k):
        d = np.sum((pos - pos[last]) ** 2, axis=-1)
        dists = np.minimum(dists, d)
        dists[last] = -np.inf
        last = int(np.argmax(dists))
        out[i] = last
    return out


def ball_query_numpy(
    centers: np.ndarray,
    center_mask: np.ndarray,
    pos: np.ndarray,
    mask: np.ndarray,
    radius: float,
    k: int,
):
    """First-K-by-index in-radius neighbors (inclusive boundary)."""
    m, n = centers.shape[0], pos.shape[0]
    idx = np.zeros((m, k), np.int32)
    ok = np.zeros((m, k), bool)
    for i in range(m):
        if not center_mask[i]:
            continue
        cnt = 0
        for j in range(n):
            if cnt >= k:
                break
            if not mask[j]:
                continue
            d2 = float(np.sum((centers[i] - pos[j]) ** 2))
            if d2 <= radius * radius:
                idx[i, cnt] = j
                ok[i, cnt] = True
                cnt += 1
    return idx, ok
