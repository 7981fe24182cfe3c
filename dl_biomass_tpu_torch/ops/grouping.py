"""Neighbourhood gather for set-abstraction layers (port of ``dl_biomass_tpu/ops/grouping.py``).

For every centroid, gather its K ball-query neighbours, translate them into
the centroid frame, and stack ``[feat_j, pos_j - pos_i]`` — PyG PointConv's
message order, and the channel order the folded first-layer weights expect.
"""

from __future__ import annotations

from typing import Optional

import torch


def in_radius(centers: torch.Tensor, center_mask: torch.Tensor, pos: torch.Tensor,
              mask: torch.Tensor, r2: float) -> torch.Tensor:
    """(B, M, N) bool: point j is valid and within r2 of valid centroid i, by
    ``dx*dx + dy*dy + dz*dz <= r2`` with each operation rounded on its own —
    the test the ball kernels make."""
    dx = pos[:, None, :, 0] - centers[:, :, None, 0]
    dy = pos[:, None, :, 1] - centers[:, :, None, 1]
    dz = pos[:, None, :, 2] - centers[:, :, None, 2]
    d2 = dx * dx + dy * dy + dz * dz
    return (d2 <= r2) & mask[:, None, :] & center_mask[:, :, None]


def gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather along the point axis: x (B, N, C), idx (B, ...) -> (B, ..., C)."""
    b, _, c = x.shape
    flat = idx.reshape(b, -1, 1).long().expand(-1, -1, c)
    return x.gather(1, flat).reshape(*idx.shape, c)


def group_neighborhoods(pos: torch.Tensor, feat: Optional[torch.Tensor], centers: torch.Tensor,
                        idx: torch.Tensor, nbr_mask: torch.Tensor) -> torch.Tensor:
    """(B, M, K, F+3) edge block ``[feat_j, pos_j - center_i]``; invalid slots are 0."""
    grouped_pos = gather_points(pos, idx) - centers[:, :, None, :]
    if feat is not None:
        out = torch.cat([gather_points(feat, idx), grouped_pos], dim=-1)
    else:
        out = grouped_pos
    return torch.where(nbr_mask[..., None], out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device))


def edges_from_gathered(gfeat: torch.Tensor, gpos: torch.Tensor, centers: torch.Tensor,
                        nbr_mask: torch.Tensor) -> torch.Tensor:
    """The same edge block from rows already gathered (features ``gfeat`` and
    positions ``gpos``, (B, M, K, .), by kernel 4c), in the features' dtype:
    ``where(nbr_mask, [gfeat, gpos - center], 0)``."""
    rel = (gpos - centers[:, :, None, :]).to(gfeat.dtype)
    return torch.where(nbr_mask[..., None], torch.cat([gfeat, rel], dim=-1),
                       torch.zeros((), dtype=gfeat.dtype, device=gfeat.device))
