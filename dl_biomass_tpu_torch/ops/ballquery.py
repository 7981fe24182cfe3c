"""Batched, masked ball query (port of ``dl_biomass_tpu/ops/ballquery.py``).

Returns a dense padded neighbour index matrix ``(B, M, K)`` plus a validity
mask. The selection is the exact method of the JAX package: the first K
in-radius neighbours by point index, ascending, with an inclusive boundary
(d <= r), as torch_cluster's ``radius(..., max_num_neighbors=K)`` scans them.
It runs on kernel 3 (``ops/ball_query_kernel.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dl_biomass_tpu_torch.ops import ball_query_kernel


def ball_query(centers: torch.Tensor, center_mask: torch.Tensor, pos: torch.Tensor,
               mask: torch.Tensor, *, radius: float, k: int = 64
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """centers (B, M, 3), center_mask (B, M), pos (B, N, 3), mask (B, N) ->
    idx (B, M, K) int32 (0 where invalid), nbr_mask (B, M, K) bool."""
    return ball_query_kernel.ball_query_first_k(centers, center_mask, pos, mask,
                                                radius=radius, k=k)
