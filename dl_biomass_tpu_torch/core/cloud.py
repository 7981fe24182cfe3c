"""Dense, fixed-shape point-cloud batch schema (port of ``dl_biomass_tpu/core/cloud.py``).

A batch is a dense ``(B, N, ...)`` block plus a validity mask; every op
downstream (FPS, ball query, grouping, pooling) is mask-aware, so clouds of
different sizes share one shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


def round_up(x: int, multiple: int) -> int:
    """Round ``x`` up to the next multiple of ``multiple``."""
    return -(-x // multiple) * multiple


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one, raise instead of running on the CPU
    unasked: the CPU runs only the plain PyTorch versions of the kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


@dataclass
class CloudBatch:
    """A dense batch of point clouds.

    Attributes:
      pos:  ``(B, N, 3)`` float32 — xyz coordinates (centered per cloud).
      feat: ``(B, N, F)`` float32 — per-point features (e.g. normalized intensity).
      mask: ``(B, N)`` bool — True for real points, False for padding.
      y:    ``(B, 4)`` float32 or None — biomass targets; ``(B, N, k)`` for
            per-point targets (the segmentor's).
    """

    pos: torch.Tensor
    feat: torch.Tensor
    mask: torch.Tensor
    y: Optional[torch.Tensor] = None

    @property
    def num_points(self) -> int:
        return self.pos.shape[1]

    @property
    def num_features(self) -> int:
        return self.feat.shape[-1]

    def valid_counts(self) -> torch.Tensor:
        """Number of real (non-pad) points per cloud, shape ``(B,)``."""
        return self.mask.sum(dim=1, dtype=torch.int32)

    def to(self, device) -> "CloudBatch":
        return CloudBatch(
            pos=self.pos.to(device), feat=self.feat.to(device), mask=self.mask.to(device),
            y=None if self.y is None else self.y.to(device),
        )

    @classmethod
    def from_numpy(
        cls,
        pos_list: Sequence[np.ndarray],
        feat_list: Sequence[np.ndarray],
        y: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
        device=None,
    ) -> "CloudBatch":
        """Pack variable-size numpy clouds into one dense padded batch on ``device``.

        ``capacity`` defaults to the max cloud size rounded up to 128; clouds
        longer than ``capacity`` are cut. Both as in the JAX package.
        """
        if len(pos_list) != len(feat_list) or not pos_list:
            raise ValueError("need one feature array per cloud, and at least one cloud")
        dev = resolve_device(device)
        sizes = [int(p.shape[0]) for p in pos_list]
        if capacity is None:
            capacity = round_up(max(sizes), 128)
        b = len(pos_list)
        f = int(feat_list[0].shape[1]) if feat_list[0].ndim == 2 else 1
        pos = np.zeros((b, capacity, 3), np.float32)
        feat = np.zeros((b, capacity, f), np.float32)
        mask = np.zeros((b, capacity), bool)
        for i, (p, x) in enumerate(zip(pos_list, feat_list)):
            n = min(int(p.shape[0]), capacity)
            pos[i, :n] = p[:n]
            feat[i, :n] = x[:n].reshape(n, f)
            mask[i, :n] = True
        yy = None if y is None else torch.from_numpy(np.asarray(y, np.float32)).to(dev)
        return cls(
            pos=torch.from_numpy(pos).to(dev), feat=torch.from_numpy(feat).to(dev),
            mask=torch.from_numpy(mask).to(dev), y=yy,
        )
