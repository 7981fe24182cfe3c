"""Learning-rate range test (port of ``dl_biomass_tpu/train/lr_finder.py``).

Parity with the reference's torch-lr-finder usage (``Misc/lr_finder_test.py:57-61``):
sweep the learning rate exponentially from ``start_lr`` to ``end_lr`` over
``num_iter`` steps of plain SGD, record the (smoothed) training loss per step,
and suggest the lr at the steepest descent point.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.train.loss import weighted_component_mse


def _sgd_step(model, optimizer, batch, lr: float, generator) -> torch.Tensor:
    """One train-mode step of SGD at ``lr``; returns the loss (not synced)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    out = model(batch, train=True, generator=generator)
    loss = weighted_component_mse(out, batch.y, batch.mask.any(dim=1))
    loss.backward()
    optimizer.step()
    return loss.detach()


def lr_range_test(
    model: torch.nn.Module,
    train_batches: Iterable,
    *,
    seed: int = 0,
    start_lr: float = 1e-7,
    end_lr: float = 1.0,
    num_iter: int = 100,
    smooth_f: float = 0.05,
    diverge_th: float = 5.0,
    device=None,
) -> Dict[str, object]:
    """Returns {"lr": [...], "loss": [...], "suggestion": float or None}.

    Trains a copy of ``model`` (its weights are the start; the caller's model
    is left as it was) on ``device`` (None: the card, which must exist), the
    FPS starts and dropout drawn from a generator seeded with ``seed``; the
    batches are cycled."""
    dev = resolve_device(device)
    batches = [b.to(dev) for b in train_batches]
    if not batches:
        raise ValueError("no batches")
    model = copy.deepcopy(model).to(dev)
    optimizer = torch.optim.SGD(model.parameters(), lr=start_lr)  # lr set per step
    generator = torch.Generator(device=dev).manual_seed(int(seed))

    gamma = (end_lr / start_lr) ** (1.0 / max(num_iter - 1, 1))
    lrs: List[float] = []
    losses: List[float] = []
    smoothed = None
    best = np.inf
    for i in range(num_iter):
        lr = start_lr * gamma**i
        loss = float(_sgd_step(model, optimizer, batches[i % len(batches)], lr, generator))
        if not np.isfinite(loss):
            break
        smoothed = loss if smoothed is None else smooth_f * loss + (1 - smooth_f) * smoothed
        lrs.append(lr)
        losses.append(smoothed)
        best = min(best, smoothed)
        if smoothed > diverge_th * best:
            break

    suggestion: Optional[float] = None
    if len(losses) > 3:
        grads_ = np.gradient(np.asarray(losses))
        suggestion = float(lrs[int(np.argmin(grads_))])
    return {"lr": lrs, "loss": losses, "suggestion": suggestion}
