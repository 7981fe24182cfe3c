"""Batched, masked farthest-point sampling (port of ``dl_biomass_tpu/ops/fps.py``).

Semantics:
  * iterative max-min sampling: each step picks the point with the largest
    distance to the already-selected set (ties to the first index);
  * the start is a given index per cloud, a uniform random valid point drawn
    from a ``torch.Generator`` (training, as torch_cluster's random start),
    or by default the first valid point;
  * padded (mask=False) points are never selected, and selected points are
    not selected again.

Both functions run on kernel 1 (``ops/fps_kernel.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from dl_biomass_tpu_torch.ops import fps_kernel
from dl_biomass_tpu_torch.parallel import mesh as dp

SECTORS = 8  # most sectors fps_sectored splits a cloud into


def random_starts(mask: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """(B,) a uniform random valid index per row of ``mask`` (B, N), drawn on
    the mask's device: the argmax of uniform noise over the valid points, as
    the JAX package's Gumbel argmax (``_random_start``). A row with no valid
    point gives 0. Under a mesh the noise is drawn for the whole batch's rows
    (cloud-major) and this rank keeps its own."""
    u = dp.rand_rows(mask.shape, generator, mask.device)
    return torch.where(mask, u, -1.0).argmax(dim=1)


def farthest_point_sample(pos: torch.Tensor, mask: torch.Tensor, num_samples: int, *,
                          starts: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Batched FPS: pos (B, N, 3) f32, mask (B, N) bool -> (B, num_samples) int32.

    ``starts`` (B,) gives each cloud's start; else ``generator`` draws a
    random valid point per cloud; else each cloud starts at its first valid
    point (index 0 for a cloud with none)."""
    n = pos.shape[1]
    if not 0 < num_samples <= n:
        raise ValueError(f"num_samples={num_samples} out of range for N={n}")
    if starts is None:
        starts = (random_starts(mask, generator) if generator is not None
                  else mask.to(torch.uint8).argmax(dim=1))
    return fps_kernel.fps_rows(pos, mask, starts, num_samples)


def fps_sectored(pos: torch.Tensor, mask: torch.Tensor, num_samples: int, *,
                 starts: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sectored (multi-start) FPS, the production approximation of exact FPS.

    Point i belongs to sector i % S; exact FPS runs on each sector, picking
    ``num_samples / S`` points from its start, and the picks map
    back to global indices. S halves until the points and the samples split
    evenly and each sector holds at least twice its picks; at S = 1 this is
    exact FPS (``dl_biomass_tpu/ops/fps.py:141``).

    Each of the B*S sector rows starts at ``starts`` (B*S,) local indices,
    cloud-major (B,) at S = 1, or at a random valid point of the sector drawn
    from ``generator``, or at its first valid point."""
    b, n, _ = pos.shape
    s = SECTORS
    while s > 1 and (n % s or num_samples % s or (n // s) < 2 * (num_samples // s)):
        s //= 2
    if s <= 1:
        return farthest_point_sample(pos, mask, num_samples, starts=starts,
                                     generator=generator)
    m = n // s
    k_sec = num_samples // s
    # (B, N) with N = j*s + sec -> (B, m, s) -> (B*s, m): sector-major rows,
    # copied (at B = 1 the reshape is a strided view, which kernel 1 refuses)
    pos_s = pos.reshape(b, m, s, 3).transpose(1, 2).reshape(b * s, m, 3).contiguous()
    mask_s = mask.reshape(b, m, s).transpose(1, 2).reshape(b * s, m).contiguous()
    sub = farthest_point_sample(pos_s, mask_s, k_sec, starts=starts,
                                generator=generator)  # (B*s, k_sec) local j
    sec = torch.arange(s, dtype=torch.int32, device=pos.device).view(1, s, 1)
    return (sub.view(b, s, k_sec) * s + sec).reshape(b, num_samples)
