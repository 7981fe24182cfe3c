"""Masked reductions (port of ``dl_biomass_tpu/ops/pooling.py``, forward only).

``masked_max`` stands in for PointConv's scatter-max aggregation and for
``global_max_pool``: with dense ``(B, N, C)`` batching the segments become a
max over the point axis with -inf masking.
"""

from __future__ import annotations

import torch


def _expand(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.unsqueeze(-1) if mask.dim() == x.dim() - 1 else mask


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Max over ``dim`` ignoring mask=False entries; 0 where a row has no valid entry."""
    filled = x.masked_fill(~_expand(mask, x), float("-inf"))
    out = filled.amax(dim=dim)
    any_valid = _expand(mask.any(dim=dim), out)
    return torch.where(any_valid, out, torch.zeros((), dtype=out.dtype, device=out.device))


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean over ``dim`` ignoring mask=False entries (0 where empty)."""
    m = _expand(mask, x)
    s = torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device)).sum(dim=dim)
    cnt = m.to(x.dtype).sum(dim=dim)
    return torch.where(cnt > 0, s / cnt.clamp_min(1.0), torch.zeros((), dtype=s.dtype,
                                                                    device=s.device))
