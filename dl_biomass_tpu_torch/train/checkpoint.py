"""Checkpoints with save-on-best and real resume (port of
``dl_biomass_tpu/train/checkpoint.py``).

A checkpoint is ``epoch_{epoch:05d}.pt`` in ``base_dir``: the model's
``state_dict`` (parameters and BatchNorm running statistics), the
optimizer's state, the epoch and its validation MSE, saved with
``torch.save``; ``epoch_{epoch:05d}.meta.json`` beside it holds the epoch and
val_mse, as the JAX package writes them. ``latest_checkpoint`` is the newest
by epoch. Orbax checkpoints of the JAX package are not read: weights cross
over with ``bridge.from_flax_variables``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch


def _name(epoch: int) -> str:
    return f"epoch_{epoch:05d}"


def save_checkpoint(base_dir: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer, *,
                    epoch: int, val_mse: float) -> str:
    """Save the full training state; returns the checkpoint path."""
    os.makedirs(base_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(base_dir), _name(epoch) + ".pt")
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "epoch": epoch, "val_mse": float(val_mse)}, path)
    with open(os.path.join(base_dir, _name(epoch) + ".meta.json"), "w") as f:
        json.dump({"epoch": epoch, "val_mse": float(val_mse)}, f)
    return path


def latest_checkpoint(base_dir: str) -> Optional[str]:
    """The newest checkpoint path by epoch, or None."""
    if not os.path.isdir(base_dir):
        return None
    names = sorted(d for d in os.listdir(base_dir) if d.startswith("epoch_") and d.endswith(".pt"))
    return os.path.join(os.path.abspath(base_dir), names[-1]) if names else None


def restore_latest(base_dir: str, model: torch.nn.Module,
                   optimizer: Optional[torch.optim.Optimizer] = None) -> Optional[dict]:
    """Load the newest checkpoint into ``model`` (and ``optimizer``) in place;
    returns its ``{"epoch", "val_mse"}``, or None when there is none."""
    path = latest_checkpoint(base_dir)
    if path is None:
        return None
    dev = next(model.parameters()).device
    state = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return {"epoch": state["epoch"], "val_mse": state["val_mse"]}
