"""Batched, masked farthest-point sampling (port of ``dl_biomass_tpu/ops/fps.py``).

Semantics:
  * iterative max-min sampling: each step picks the point with the largest
    distance to the already-selected set (ties to the first index);
  * the start is a given index per cloud, by default the first valid point;
  * padded (mask=False) points are never selected, and selected points are
    not selected again.

Both functions run on kernel 1 (``ops/fps_kernel.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from dl_biomass_tpu_torch.ops import fps_kernel

SECTORS = 8  # most sectors fps_sectored splits a cloud into


def farthest_point_sample(pos: torch.Tensor, mask: torch.Tensor, num_samples: int, *,
                          starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched FPS: pos (B, N, 3) f32, mask (B, N) bool -> (B, num_samples) int32.

    ``starts`` (B,) gives each cloud's start; by default the first valid point
    of each cloud (index 0 for a cloud with none)."""
    n = pos.shape[1]
    if not 0 < num_samples <= n:
        raise ValueError(f"num_samples={num_samples} out of range for N={n}")
    if starts is None:
        starts = mask.to(torch.uint8).argmax(dim=1)
    return fps_kernel.fps_rows(pos, mask, starts, num_samples)


def fps_sectored(pos: torch.Tensor, mask: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Sectored (multi-start) FPS, the production approximation of exact FPS.

    Point i belongs to sector i % S; exact FPS runs on each sector, picking
    ``num_samples / S`` points from its first valid point, and the picks map
    back to global indices. S halves until the points and the samples split
    evenly and each sector holds at least twice its picks; at S = 1 this is
    exact FPS (``dl_biomass_tpu/ops/fps.py:141``)."""
    b, n, _ = pos.shape
    s = SECTORS
    while s > 1 and (n % s or num_samples % s or (n // s) < 2 * (num_samples // s)):
        s //= 2
    if s <= 1:
        return farthest_point_sample(pos, mask, num_samples)
    m = n // s
    k_sec = num_samples // s
    # (B, N) with N = j*s + sec -> (B, m, s) -> (B*s, m): sector-major rows
    pos_s = pos.reshape(b, m, s, 3).transpose(1, 2).reshape(b * s, m, 3)
    mask_s = mask.reshape(b, m, s).transpose(1, 2).reshape(b * s, m)
    sub = farthest_point_sample(pos_s, mask_s, k_sec)  # (B*s, k_sec) local j
    sec = torch.arange(s, dtype=torch.int32, device=pos.device).view(1, s, 1)
    return (sub.view(b, s, k_sec) * s + sec).reshape(b, num_samples)
