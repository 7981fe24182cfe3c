"""Weighted multi-component biomass loss (port of ``dl_biomass_tpu/train/loss.py``).

Per-component MSE combined with fixed weights 1/11, 1/12, 1/5, 1/72 for
bark, branch, foliage and wood (the reference's ``main.py:157-169``); and
the segmentor's per-point MSE (``per_point_mse``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

# bark, branch, foliage, wood
COMPONENT_WEIGHTS: Tuple[float, float, float, float] = (1 / 11, 1 / 12, 1 / 5, 1 / 72)
COMPONENT_NAMES = ("bark", "branch", "foliage", "wood")


def weighted_component_mse(pred: torch.Tensor, target: torch.Tensor,
                           sample_weight: Optional[torch.Tensor] = None,
                           total_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar loss: sum_c w_c * MSE_c, the MSE over the batch per component.
    ``sample_weight`` (B,) is 0/1, 0 for pad clouds. ``total_weight`` divides
    in place of ``sample_weight``'s sum: the real clouds of the whole batch
    when this is one rank's share of it, so that the ranks' shares add up to
    the whole batch's mean however the pad clouds fall."""
    se = torch.square(pred - target)  # (B, 4)
    if sample_weight is None:
        per_comp = se.mean(dim=0)
    else:
        w = sample_weight.to(se.dtype)[:, None]
        n = w.sum() if total_weight is None else total_weight.to(se.dtype)
        per_comp = (se * w).sum(dim=0) / torch.clamp_min(n, 1.0)
    return (per_comp * _weights(se.dtype, se.device)).sum()


def per_point_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                  total_points: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-point MSE of pred and target (B, N, k) over the valid points of
    ``mask`` (B, N): the squared error summed over every valid point and
    output, over k times the valid points (the historical segmentor loop's
    ``F.mse_loss`` over the batch's flattened points). ``total_points``
    counts the points in place of ``mask``'s sum: the whole batch's when
    this is one rank's share of it."""
    se = torch.square(pred - target).sum(dim=-1)
    n = mask.sum().to(se.dtype) if total_points is None else total_points.to(se.dtype)
    total = torch.where(mask, se, torch.zeros((), dtype=se.dtype, device=se.device)).sum()
    return total / (torch.clamp_min(n, 1.0) * pred.shape[-1])


@functools.lru_cache(maxsize=None)
def _weights(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # made once per device: a host-to-device copy in every step would wait
    # for the device. Made outside inference mode, so that a first call from
    # an evaluation does not cache a tensor that a training step cannot save
    with torch.inference_mode(False):
        return torch.tensor(COMPONENT_WEIGHTS, dtype=dtype, device=device)
