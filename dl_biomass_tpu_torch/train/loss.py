"""Weighted multi-component biomass loss (port of ``dl_biomass_tpu/train/loss.py``).

Per-component MSE combined with fixed weights 1/11, 1/12, 1/5, 1/72 for
bark, branch, foliage and wood (the reference's ``main.py:157-169``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

# bark, branch, foliage, wood
COMPONENT_WEIGHTS: Tuple[float, float, float, float] = (1 / 11, 1 / 12, 1 / 5, 1 / 72)
COMPONENT_NAMES = ("bark", "branch", "foliage", "wood")


def weighted_component_mse(pred: torch.Tensor, target: torch.Tensor,
                           sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar loss: sum_c w_c * MSE_c, the MSE over the batch per component.
    ``sample_weight`` (B,) is 0/1, 0 for pad clouds."""
    se = torch.square(pred - target)  # (B, 4)
    if sample_weight is None:
        per_comp = se.mean(dim=0)
    else:
        w = sample_weight.to(se.dtype)[:, None]
        per_comp = (se * w).sum(dim=0) / torch.clamp_min(w.sum(), 1.0)
    return (per_comp * _weights(se.dtype, se.device)).sum()


@functools.lru_cache(maxsize=None)
def _weights(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # made once per device: a host-to-device copy in every step would wait
    # for the device. Made outside inference mode, so that a first call from
    # an evaluation does not cache a tensor that a training step cannot save
    with torch.inference_mode(False):
        return torch.tensor(COMPONENT_WEIGHTS, dtype=dtype, device=device)
