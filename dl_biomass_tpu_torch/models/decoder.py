"""Feature-propagation decoder and the per-point segmentor (port of
``dl_biomass_tpu/models/decoder.py``).

The reference's historical per-point biomass regressor
(``Misc/Lukas_OG_Scripts/pn2_regressor.py:34-45,57-59``): a PointNet++ encoder,
then ``knn_interpolate`` (inverse-distance weights over the 3 nearest coarse
points, dense and masked) and skip MLPs (``FPModule``) back down to every
input point. The encoder is the port's ``SAModule`` with the settings
``PointNet2Regressor`` passes it (``build_model`` under ``model.family =
"segmentor"``: bf16, sectored FPS on kernel 1, the stratified SA1 grouping on
kernel 2, the exact ball query on kernel 3, SA2's split first layer gathered
by kernel 4a, its backward kernel 4b); the constructor's defaults are the
JAX package's float32 exact path. The FP MLPs and the head compute in the
same dtype as the encoder. The kNN selection is ``torch.topk`` over the
dense distances, as the JAX package's is ``lax.top_k``: no Pallas kernel.

While spans are recorded (``utils/profiling``), the forward records
``model.sa1``, ``model.sa2``, ``model.sa3``, ``model.fp3``, ``model.fp2``,
``model.fp1`` and ``model.seg_head``, and ``knn_interpolate`` records
``fp.knn`` (distances, mask, top-k, weights) with the counters ``knn.pairs``
(valid target x valid source pairs, summed on the device) and
``knn.slots`` (the B x N x M distances the dense selection computes).
Per-point models take neither ``mp`` point sharding nor the serving engine.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from dl_biomass_tpu_torch.models.layers import MLP
from dl_biomass_tpu_torch.models.pointnet2 import GlobalSAModule, SAModule
from dl_biomass_tpu_torch.ops.grouping import gather_points
from dl_biomass_tpu_torch.parallel import mesh as dp
from dl_biomass_tpu_torch.utils import profiling


def knn_interpolate(feat_src: torch.Tensor, pos_src: torch.Tensor, src_mask: torch.Tensor,
                    pos_dst: torch.Tensor, dst_mask: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Inverse-squared-distance weighted kNN interpolation of ``feat_src`` (B, M,
    C) at ``pos_src`` (B, M, 3) onto ``pos_dst`` (B, N, 3) -> (B, N, C), 0 at
    invalid targets. Invalid sources are never neighbours (weight 0 where a
    cloud has fewer than k). The weights come from the positions, which carry
    no gradient; the features' gradient is a scatter of the weights."""
    k = min(k, pos_src.shape[1])
    with profiling.span("fp.knn", device=pos_dst), torch.no_grad():
        if profiling.enabled():
            profiling.count("knn.pairs", (dst_mask.sum(1) * src_mask.sum(1)).sum())
            profiling.count("knn.slots", dst_mask.numel() * src_mask.shape[1])
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
    concatenate the skip features, shared MLP (``pn2_regressor.py:34-45``),
    the MLP's inputs in ``compute_dtype``."""

    def __init__(self, mlp_channels: Sequence[int], k: int = 3, act: Optional[str] = "ReLU",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k = k
        self.compute_dtype = compute_dtype
        self.mlp = MLP(mlp_channels, act=act, compute_dtype=compute_dtype)

    def forward(self, feat_src, pos_src, src_mask, feat_skip, pos_dst, dst_mask, *,
                train: bool = False):
        x = knn_interpolate(feat_src, pos_src, src_mask, pos_dst, dst_mask, self.k)
        if feat_skip is not None:
            cdt = self.compute_dtype
            x = torch.cat([x.to(cdt), feat_skip.to(cdt)], dim=-1)
        return self.mlp(x, dst_mask, train)


class PointNet2Segmentor(nn.Module):
    """Per-point regressor: SA encoder, FP decoder, pointwise head — the
    historical per-point biomass variant (predicted-LAS dumps,
    ``Misc/Lukas_OG_Scripts/main.py:92-100``). ``forward(cloud, train=,
    generator=)`` -> (B, N, num_outputs) float32, 0 at invalid points; the
    generator draws the FPS starts and the head's dropout, as in
    ``PointNet2Regressor``. The encoder's settings (``sa1_ratio`` to
    ``split_first_layer``, ``compute_dtype``) reach SA1 and SA2 as the
    regressor passes them."""

    def __init__(self, num_features: int, activation_function: str = "ReLU",
                 num_outputs: int = 1, dropout_probability: float = 0.0,
                 sa1_ratio: float = 0.2, sa1_radius: float = 2.0, sa2_ratio: float = 0.25,
                 sa2_radius: float = 8.0, max_neighbors: int = 64, fast_group: bool = False,
                 fast_fps: bool = False, exact_selection: bool = False,
                 split_first_layer: bool = True, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_features, self.num_outputs = num_features, num_outputs
        self.activation_function = activation_function
        self.dropout_probability = dropout_probability
        self.sa1_ratio, self.sa1_radius = sa1_ratio, sa1_radius
        self.sa2_ratio, self.sa2_radius = sa2_ratio, sa2_radius
        self.max_neighbors = max_neighbors
        self.fast_group, self.fast_fps = fast_group, fast_fps
        self.exact_selection = exact_selection
        self.split_first_layer = split_first_layer
        self.compute_dtype = compute_dtype
        f = num_features if num_features else 3
        act = activation_function
        common = dict(act=act, max_neighbors=max_neighbors, compute_dtype=compute_dtype,
                      fast_fps=fast_fps, exact_selection=exact_selection,
                      split_first_layer=split_first_layer)
        self.sa1 = SAModule(sa1_ratio, sa1_radius, [3 + f, 64, 64, 128], fast_group=fast_group,
                            **common)
        self.sa2 = SAModule(sa2_ratio, sa2_radius, [128 + 3, 128, 128, 256], **common)
        self.sa3 = GlobalSAModule([256 + 3, 256, 512, 1024], act=act,
                                  compute_dtype=compute_dtype)
        self.fp3 = FPModule([1024 + 256, 256, 256], act=act, compute_dtype=compute_dtype)
        self.fp2 = FPModule([256 + 128, 256, 128], act=act, compute_dtype=compute_dtype)
        self.fp1 = FPModule([128 + f, 128, 128, 128], act=act, compute_dtype=compute_dtype)
        self.head = MLP([128, 128, num_outputs], act=act, compute_dtype=compute_dtype,
                        dropout=dropout_probability)

    def forward(self, cloud, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if dp.point_parts() > 1:
            raise ValueError("PointNet2Segmentor takes no mp point sharding (mp > 1): its "
                             "decoder runs on whole clouds")
        feat, pos, mask = cloud.feat, cloud.pos, cloud.mask
        dev = pos.device
        if self.num_features == 0:
            feat = pos
        with profiling.span("model.sa1", device=dev):
            h1, pos1, mask1 = self.sa1(feat, pos, mask, train=train, generator=generator)
        with profiling.span("model.sa2", device=dev):
            h2, pos2, mask2 = self.sa2(h1, pos1, mask1, train=train, generator=generator)
        with profiling.span("model.sa3", device=dev):
            hg = self.sa3(h2, pos2, mask2, train=train)
        # the global vector broadcast back down the pyramid
        hg2 = hg[:, None, :].expand(*h2.shape[:2], hg.shape[-1])
        with profiling.span("model.fp3", device=dev):
            d2 = self.fp3(hg2, pos2, mask2, h2, pos2, mask2, train=train)
        with profiling.span("model.fp2", device=dev):
            d1 = self.fp2(d2, pos2, mask2, h1, pos1, mask1, train=train)
        with profiling.span("model.fp1", device=dev):
            d0 = self.fp1(d1, pos1, mask1, feat, pos, mask, train=train)
        with profiling.span("model.seg_head", device=dev):
            out = self.head(d0, mask, train, generator)
            return torch.where(mask[..., None], out, torch.zeros(
                (), dtype=out.dtype, device=out.device)).float()


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
