"""Dense voxel-grid CNN biomass regressor (port of ``dl_biomass_tpu/models/voxelnet.py``),
the dense counterpart of the reference's MinkowskiEngine probe
(``Misc/Minkowski_Engine/Minkowski_Main_V1.py:4-35``):

    conv1: k=3, stride 2, no bias (in -> 64)  + BatchNorm + act
    conv2: k=3, stride 2, bias    (64 -> 128) + BatchNorm + act
    global mean over the sample's occupied sites, then Linear(128 -> out)

Each voxel's input is ``[log1p(count), mean features, mean sub-voxel offset
(3)]`` (``ops/voxelize.py``). BatchNorm takes its statistics over occupied
sites only, and the occupancy follows the stride-2 convolutions by a 2x2x2
max pool of the mask. The grid is kept channels-last, as ``MaskedBatchNorm``
normalizes the last axis, and permuted around ``F.conv3d`` (cuDNN on the
card; the JAX package's ``conv_general_dilated`` is no Pallas kernel either).

flax's ``padding="SAME"`` pads the low side by the floor of half the total
and the high side by the rest: (0, 1) for a stride-2, 3-wide convolution of
an even grid, (1, 1) of an odd one, and (0, 1) for the mask's 2-wide pool of
an odd grid. ``F.pad`` reproduces that; ``Conv3d(padding=1)`` would pad (1, 1)
everywhere, another function with the same output shape.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dl_biomass_tpu_torch.models.layers import MaskedBatchNorm, resolve_activation
from dl_biomass_tpu_torch.ops.voxelize import voxelize


def same_padding(size: int, window: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one axis under flax/XLA ``"SAME"``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad3(x: torch.Tensor, size: int, window: int, stride: int, value: float = 0.0):
    """Pad the three grid axes of channels-first ``x`` (B, C, G, G, G)."""
    lo, hi = same_padding(size, window, stride)
    return F.pad(x, (lo, hi) * 3, value=value) if lo or hi else x


class VoxelNet(nn.Module):
    """Voxel CNN regressor over ``CloudBatch`` inputs. ``channels=(64, 128)``
    (stride 2 each) is the probe's stack; the names (``conv1``, ``bn1``, ...,
    ``head``) are the flax tree's, so the bridge maps it one to one.
    ``forward(cloud, train=, generator=)`` takes the generator ``Trainer``
    hands every model and draws nothing from it."""

    def __init__(self, num_features: int, num_outputs: int = 4, grid: int = 32,
                 extent: float = 0.0, channels: Sequence[int] = (64, 128),
                 activation_function: str = "ReLU",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_features, self.num_outputs = num_features, num_outputs
        self.grid, self.extent = grid, extent  # extent 0: adapt per cloud
        self.channels = tuple(channels)
        self.activation_function = activation_function
        self.compute_dtype = compute_dtype
        cin = self.voxel_channels
        for i, width in enumerate(self.channels):
            # torch's default init is U(+-1/sqrt(27 cin)) for both, as the JAX
            # package draws them (torch_linear_init(cin * 27)); the probe's
            # conv1 has no bias
            setattr(self, f"conv{i + 1}", nn.Conv3d(cin, width, 3, stride=2, bias=i > 0))
            setattr(self, f"bn{i + 1}", MaskedBatchNorm(width))
            cin = width
        self.head = nn.Linear(cin, num_outputs)

    @property
    def voxel_channels(self) -> int:
        """Input channels of conv1: log1p(count) + F feature means + 3 offsets."""
        return 1 + self.num_features + 3

    def param_count(self) -> int:
        """Closed-form parameter count: the 27 x Cin x Cout kernels a Minkowski
        k=3, D=3 convolution carries, conv2's bias, BatchNorm's affine, the head."""
        total, cin = 0, self.voxel_channels
        for i, w in enumerate(self.channels):
            total += 27 * cin * w + (w if i > 0 else 0) + 2 * w
            cin = w
        return total + cin * self.num_outputs + self.num_outputs

    def forward(self, cloud, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, num_outputs) float32 predictions; ``train=True`` normalizes by
        the batch statistics over occupied sites and updates the running ones."""
        act = resolve_activation(self.activation_function)
        cdt = self.compute_dtype
        counts, feat_sum, off_sum = voxelize(
            cloud.pos, cloud.feat, cloud.mask, grid=self.grid,
            extent=None if self.extent == 0.0 else self.extent)
        denom = torch.clamp_min(counts, 1.0)[..., None]
        x = torch.cat([torch.log1p(counts)[..., None], feat_sum / denom, off_sum / denom],
                      dim=-1)  # (B, G, G, G, C0)
        mask = counts > 0
        size = self.grid
        for i in range(len(self.channels)):
            conv, bn = getattr(self, f"conv{i + 1}"), getattr(self, f"bn{i + 1}")
            xc = _pad3(x.to(cdt).permute(0, 4, 1, 2, 3), size, 3, 2)
            y = F.conv3d(xc, conv.weight.to(cdt), stride=2)
            if conv.bias is not None:  # added in the compute dtype, as flax adds it
                y = y + conv.bias.to(cdt)[:, None, None, None]
            x = y.permute(0, 2, 3, 4, 1)  # channels-last again
            # a site exists at the new stride if any site of its footprint did
            # (Minkowski's stride-2 coordinate downsample)
            m = _pad3(mask[:, None].float(), size, 2, 2, value=-math.inf)
            mask = F.max_pool3d(m, 2, stride=2)[:, 0] > 0
            size = -(-size // 2)
            x = bn(x, mask, train)
            if act is not None:
                x = act(x)
        # the mean over occupied sites (MinkowskiGlobalPooling)
        mf = mask[..., None].float()
        pooled = (x.float() * mf).sum(dim=(1, 2, 3)) / torch.clamp_min(mf.sum(dim=(1, 2, 3)), 1.0)
        return self.head(pooled).float()
