"""Augmentation visualizer — side-by-side original vs augmented cloud renders
(port of ``dl_biomass_tpu/experiments/visualize_augmentation.py``).

Parity with the reference ``Visualize_Augmentation.py:16-167``, driven by the
on-device transforms (``transforms/augment.augment_cloud``) instead of
standalone numpy copies. The figure needs matplotlib, imported only when a
figure is drawn: where it is not installed, no figure is written and one line
says so (as ``eval/testing.figure_module`` does for the evaluation figures).
"""

from __future__ import annotations

import importlib.util
from typing import Optional

import numpy as np
import torch


def visualize_augmentation(
    pos: np.ndarray,
    feat: Optional[np.ndarray] = None,
    out_path: Optional[str] = None,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """Augment one cloud on ``device`` (None: the card, which must exist) with
    a generator seeded from ``seed``; render (original | augmented) 3-D
    scatters to ``out_path`` where matplotlib is installed. Returns the
    augmented cloud's valid points, (n', 3)."""
    from dl_biomass_tpu_torch.core.cloud import resolve_device
    from dl_biomass_tpu_torch.transforms.augment import aug_capacity, augment_cloud

    dev = resolve_device(device)
    pos = np.asarray(pos, np.float32)
    n = len(pos)
    cap = aug_capacity(n)
    p = np.zeros((cap, 3), np.float32)
    p[:n] = pos
    f = np.zeros((cap, 1), np.float32)
    if feat is not None:
        f[:n] = np.asarray(feat, np.float32).reshape(n, -1)[:, :1]
    m = np.zeros(cap, bool)
    m[:n] = True

    g = torch.Generator(device=dev).manual_seed(int(seed))
    ap, _, am = augment_cloud(g, torch.from_numpy(p).to(dev), torch.from_numpy(f).to(dev),
                              torch.from_numpy(m).to(dev), n)
    aug = ap[am].cpu().numpy()

    if out_path is None:
        return aug
    if importlib.util.find_spec("matplotlib") is None:
        print(f"matplotlib is not installed: {out_path} not written")
        return aug
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=[20, 10])
    ax = fig.add_subplot(121, projection="3d")
    ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c=pos[:, 2], cmap="viridis", linewidth=0.5)
    ax.set_title(f"Original ({n} pts)")
    ax = fig.add_subplot(122, projection="3d")
    ax.scatter(aug[:, 0], aug[:, 1], aug[:, 2], c=aug[:, 2], cmap="viridis", linewidth=0.5)
    ax.set_title(f"Augmented ({len(aug)} pts)")
    plt.savefig(out_path)
    plt.close(fig)
    return aug
