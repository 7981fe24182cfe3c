"""Feature-propagation decoder and the per-point segmentor (port of
``dl_biomass_tpu/models/decoder.py``).

The reference's historical per-point biomass regressor
(``Misc/Lukas_OG_Scripts/pn2_regressor.py:34-45,57-59``): a PointNet++ encoder,
then ``knn_interpolate`` (inverse-distance weights over the 3 nearest coarse
points, dense and masked) and skip MLPs (``FPModule``) back down to every
input point. The encoder is the port's ``SAModule``: exact FPS on kernel 1,
the exact ball query on kernel 3, SA2's split first layer gathered by kernel
4a (its backward kernel 4b). The kNN selection is ``torch.topk`` over the
dense distances, as the JAX package's is ``lax.top_k``: no Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from dl_biomass_tpu_torch.models.layers import MLP
from dl_biomass_tpu_torch.models.pointnet2 import GlobalSAModule, SAModule
from dl_biomass_tpu_torch.ops.grouping import gather_points


def knn_interpolate(feat_src: torch.Tensor, pos_src: torch.Tensor, src_mask: torch.Tensor,
                    pos_dst: torch.Tensor, dst_mask: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Inverse-squared-distance weighted kNN interpolation of ``feat_src`` (B, M,
    C) at ``pos_src`` (B, M, 3) onto ``pos_dst`` (B, N, 3) -> (B, N, C), 0 at
    invalid targets. Invalid sources are never neighbours (weight 0 where a
    cloud has fewer than k). The weights come from the positions, which carry
    no gradient; the features' gradient is a scatter of the weights."""
    k = min(k, pos_src.shape[1])
    with torch.no_grad():
        d2 = sum((pos_dst[:, :, None, c] - pos_src[:, None, :, c]) ** 2 for c in range(3))
        d2 = torch.where(src_mask[:, None, :], d2, torch.inf)  # (B, N, M)
        neg_d2, idx = torch.topk(-d2, k, dim=-1)
        w = 1.0 / torch.clamp_min(-neg_d2, 1e-16)
        w = torch.where(torch.isfinite(w), w, 0.0)
        w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-16)
    out = (gather_points(feat_src, idx) * w[..., None]).sum(dim=2)
    return torch.where(dst_mask[..., None], out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device))


class FPModule(nn.Module):
    """Feature propagation: interpolate coarse features onto the fine points,
    concatenate the skip features, shared MLP (``pn2_regressor.py:34-45``)."""

    def __init__(self, mlp_channels: Sequence[int], k: int = 3, act: Optional[str] = "ReLU"):
        super().__init__()
        self.k = k
        self.mlp = MLP(mlp_channels, act=act)

    def forward(self, feat_src, pos_src, src_mask, feat_skip, pos_dst, dst_mask, *,
                train: bool = False):
        x = knn_interpolate(feat_src, pos_src, src_mask, pos_dst, dst_mask, self.k)
        if feat_skip is not None:
            x = torch.cat([x, feat_skip], dim=-1)
        return self.mlp(x, dst_mask, train)


class PointNet2Segmentor(nn.Module):
    """Per-point regressor: SA encoder, FP decoder, pointwise head — the
    historical per-point biomass variant (predicted-LAS dumps,
    ``Misc/Lukas_OG_Scripts/main.py:92-100``). ``forward(cloud, train=,
    generator=)`` -> (B, N, num_outputs) float32, 0 at invalid points; the
    generator draws the FPS starts and the head's dropout, as in
    ``PointNet2Regressor``."""

    def __init__(self, num_features: int, activation_function: str = "ReLU",
                 num_outputs: int = 1, dropout_probability: float = 0.0):
        super().__init__()
        self.num_features, self.num_outputs = num_features, num_outputs
        self.activation_function = activation_function
        self.dropout_probability = dropout_probability
        f = num_features if num_features else 3
        act = activation_function
        self.sa1 = SAModule(0.2, 2.0, [3 + f, 64, 64, 128], act=act)
        self.sa2 = SAModule(0.25, 8.0, [128 + 3, 128, 128, 256], act=act)
        self.sa3 = GlobalSAModule([256 + 3, 256, 512, 1024], act=act)
        self.fp3 = FPModule([1024 + 256, 256, 256], act=act)
        self.fp2 = FPModule([256 + 128, 256, 128], act=act)
        self.fp1 = FPModule([128 + f, 128, 128, 128], act=act)
        self.head = MLP([128, 128, num_outputs], act=act, dropout=dropout_probability)

    def forward(self, cloud, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat, pos, mask = cloud.feat, cloud.pos, cloud.mask
        if self.num_features == 0:
            feat = pos
        h1, pos1, mask1 = self.sa1(feat, pos, mask, train=train, generator=generator)
        h2, pos2, mask2 = self.sa2(h1, pos1, mask1, train=train, generator=generator)
        hg = self.sa3(h2, pos2, mask2, train=train)
        # the global vector broadcast back down the pyramid
        hg2 = hg[:, None, :].expand(*h2.shape[:2], hg.shape[-1])
        d2 = self.fp3(hg2, pos2, mask2, h2, pos2, mask2, train=train)
        d1 = self.fp2(d2, pos2, mask2, h1, pos1, mask1, train=train)
        d0 = self.fp1(d1, pos1, mask1, feat, pos, mask, train=train)
        out = self.head(d0, mask, train, generator)
        return torch.where(mask[..., None], out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device)).float()


def dump_predicted_las(path, pos, mask, ref, pred) -> None:
    """Write one cloud's per-point observed and predicted values as the LAS
    Extra Bytes dimensions ``ref`` and ``pred`` (the historical segmentor
    loop's per-epoch file, ``Misc/Lukas_OG_Scripts/main.py:92-100``), valid
    points only. Uncompressed LAS: the codec writes no LAZ.

    pos (N, 3), mask (N,) bool, ref and pred (N,) per-point values: numpy
    arrays or tensors on any device."""
    from dl_biomass_tpu_torch.io.reader import write_las

    def host(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

    m = host(mask).astype(bool)
    write_las(host(pos).astype(np.float64)[m], path,
              {"ref": host(ref).astype(np.float64).reshape(-1)[m],
               "pred": host(pred).astype(np.float64).reshape(-1)[m]})
