"""PointNet++ (SSG) biomass regressor (port of ``dl_biomass_tpu/models/pointnet2.py``).

  SA1: fps ratio 0.2,  ball r=2,  MLP[3+F, 64, 64, 128]
  SA2: fps ratio 0.25, ball r=8,  MLP[128+3, 128, 128, 256]
  SA3: global — MLP[256+3, 256, 512, 1024] + masked global max pool
  head: MLP[1024, 128, 128, 4], act=None

The forward takes the branches that ``model.apply`` takes in the JAX package
with its kernels on (``use_pallas=True``): sectored or exact FPS on kernel 1;
the stratified SA1 grouping on kernel 2 (``fast_group``; its edges carry no
gradient) or the exact ball query on kernel 3 (SA2 always, SA1 under
``exact_selection``). While SA2's input holds at most ``MXU_MAX_POINTS``
points (and has at least 16 features: the JAX package's ``use_mxu``), SA2
gathers through kernel 4, whose scatter-add backward is SA1's only gradient
path: the per-point first layer's z-table (``split_first_layer``), or else
the features with the positions as the gradient-free aux table (kernel 4c),
from which it builds the edges ``[h1_j, c1_j - c2_i]``. Beyond that bound,
SA2 gathers those edges with ``group_neighborhoods``, as the JAX package
does. Under ``fused_sa`` each SA layer's MLP and max run as kernel 6
(``FusedSAMLP``) on the same inputs: kernel 2's float32 edges as its planes
at SA1, the gathered features (masked) as its dense block and the
centroid-relative positions as its planes at SA2 (kernel 4c), or the
``group_neighborhoods`` edges as its dense block; the split first layer is
off there, as in the JAX package. ``train=True`` uses batch statistics in
every BatchNorm and the head's dropout, with FPS starts and dropout drawn
from the ``generator`` passed in (without one, FPS starts at the first valid
point).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from dl_biomass_tpu_torch.models.layers import MLP, FusedSAMLP, dot_f32
from dl_biomass_tpu_torch.ops import ball_group_kernel, gather_kernel
from dl_biomass_tpu_torch.ops.ballquery import ball_query
from dl_biomass_tpu_torch.ops.fps import farthest_point_sample, fps_sectored
from dl_biomass_tpu_torch.ops.grouping import (edges_from_gathered, gather_points,
                                             group_neighborhoods)
from dl_biomass_tpu_torch.ops.pooling import masked_max

# the JAX package gathers SA2's z-table with its one-hot kernel only while the
# table (SA1's centroids) holds at most this many rows (pointnet2.py:172,
# inference.py:233); beyond it the edges are gathered unsplit
MXU_MAX_POINTS = 4096
# the activations kernel 6 computes; under fused_sa any other keeps the unfused MLP
FUSED_SA_ACTS = (None, "None", "ReLU", "LeakyReLU", "ELU")


def sample_centroids(pos, mask, m: int, *, sectored: bool, generator=None):
    """FPS (sectored or exact; random starts from ``generator``, else the first
    valid point) -> (idx, centers, center_mask)."""
    fps = fps_sectored if sectored else farthest_point_sample
    idx = fps(pos, mask, m, generator=generator)
    centers = gather_points(pos, idx)
    center_mask = mask.gather(1, idx.long())
    return idx, centers, center_mask


class SAModule(nn.Module):
    """Set-abstraction layer: FPS -> neighbours -> grouped pointwise MLP -> max."""

    def __init__(self, ratio: float, radius: float, mlp_channels: Sequence[int],
                 act: Optional[str] = "ReLU", max_neighbors: int = 64,
                 compute_dtype: torch.dtype = torch.float32, fast_group: bool = False,
                 fast_fps: bool = False, exact_selection: bool = False,
                 split_first_layer: bool = True, fused_sa: bool = False):
        super().__init__()
        self.ratio, self.radius = ratio, radius
        self.max_neighbors = max_neighbors
        self.compute_dtype = compute_dtype
        self.fast_group, self.fast_fps = fast_group, fast_fps
        self.exact_selection = exact_selection
        self.split_first_layer = split_first_layer
        # the JAX package's use_fused_sa: kernel 6 takes K=64, two hidden layers
        # and its four activations
        self.fused_sa = (fused_sa and max_neighbors == 64 and len(mlp_channels) == 4
                         and act in FUSED_SA_ACTS)
        mlp_cls = FusedSAMLP if self.fused_sa else MLP
        self.mlp = mlp_cls(mlp_channels, act=act, compute_dtype=compute_dtype)

    def forward(self, feat, pos, mask, *, train: bool = False, generator=None):
        n = pos.shape[1]
        m = math.ceil(self.ratio * n)
        cdt = self.compute_dtype
        _, centers, center_mask = sample_centroids(
            pos, mask, m, sectored=self.fast_fps and not self.exact_selection,
            generator=generator)
        if (self.fast_group and not self.exact_selection and self.max_neighbors == 64
                and (feat is None or feat.shape[-1] <= 4)):
            _, nbr_mask, edges = ball_group_kernel.ball_group(
                centers, center_mask, pos, mask, feat, radius=self.radius,
                out_dtype=torch.float32 if self.fused_sa else cdt, need_idx=False)
            if self.fused_sa:  # the float32 edges [feat, rel] are kernel 6's planes
                return self.mlp(None, edges, nbr_mask, train), centers, center_mask
            h = self.mlp(edges.detach(), nbr_mask, train)
            return masked_max(h, nbr_mask, dim=2), centers, center_mask

        nbr_idx, nbr_mask = ball_query(centers, center_mask, pos, mask, radius=self.radius,
                                       k=self.max_neighbors)
        use_mxu = (feat is not None and feat.shape[-1] >= 16 and n <= MXU_MAX_POINTS
                   and self.max_neighbors == 64)
        if use_mxu and self.split_first_layer and not self.fused_sa:
            # layer 0 is linear in [x_j, p_j - p_i]: z0 = (Wf x_j + Wp p_j + b0) - Wp p_i
            # runs once per point, and kernel 4 gathers the z-table. Each use
            # casts wp on its own, as JAX does, so the two bf16 gradients of
            # wp meet in float32
            lin0 = self.mlp.lin0
            w0 = lin0.weight.t()
            fdim = feat.shape[-1]
            wf, wp = w0[:fdim], w0[fdim:]
            zpt = (dot_f32(feat.to(cdt), wf.to(cdt)) + dot_f32(pos.to(cdt), wp.to(cdt))
                   + lin0.bias).to(cdt)
            gz = gather_kernel.gather_rows(zpt, nbr_idx)
            cshift = dot_f32(centers.to(cdt), wp.to(cdt))
            z0 = gz - cshift[:, :, None, :].to(gz.dtype)
            h = self.mlp.from_z0(z0, nbr_mask, train)
        else:
            if use_mxu:
                # features (differentiable) and positions (the gradient-free aux
                # table) gathered by one index, kernel 4c
                gfeat, gpos = gather_kernel.gather_rows(feat, nbr_idx, aux=pos)
                if self.fused_sa:  # dense: the masked features; planes: p_j - c_i
                    dense = torch.where(nbr_mask[..., None], gfeat,
                                        torch.zeros((), dtype=gfeat.dtype, device=gfeat.device))
                    planes = gpos - centers[:, :, None, :]
                    return self.mlp(dense, planes, nbr_mask, train), centers, center_mask
                grouped = edges_from_gathered(gfeat, gpos, centers, nbr_mask)
            else:
                grouped = group_neighborhoods(pos, feat, centers, nbr_idx, nbr_mask)
                if self.fused_sa:
                    return self.mlp(grouped, None, nbr_mask, train), centers, center_mask
            h = self.mlp(grouped, nbr_mask, train)
        return masked_max(h, nbr_mask, dim=2), centers, center_mask


class GlobalSAModule(nn.Module):
    """Global set abstraction: MLP over [feat, pos], then a masked global max."""

    def __init__(self, mlp_channels: Sequence[int], act: Optional[str] = "ReLU",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = MLP(mlp_channels, act=act, compute_dtype=compute_dtype)

    def forward(self, feat, pos, mask, *, train: bool = False):
        return masked_max(self.mlp(torch.cat([feat, pos], dim=-1), mask, train), mask, dim=1)


class PointNet2Regressor(nn.Module):
    """The reference ``Net(num_features, activation_function,
    neuron_multiplier, dropout_probability)``, with the JAX package's knobs."""

    def __init__(self, num_features: int, activation_function: str = "ReLU",
                 neuron_multiplier: int = 0, dropout_probability: float = 0.5,
                 sa1_ratio: float = 0.2, sa1_radius: float = 2.0, sa2_ratio: float = 0.25,
                 sa2_radius: float = 8.0, max_neighbors: int = 64,
                 doubled_radius: bool = False, fast_group: bool = False,
                 fast_fps: bool = False, exact_selection: bool = False,
                 split_first_layer: bool = True, fused_sa: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_features = num_features
        self.activation_function = activation_function
        self.neuron_multiplier = neuron_multiplier
        self.dropout_probability = dropout_probability  # the head's, in training
        self.sa1_ratio, self.sa2_ratio = sa1_ratio, sa2_ratio
        self.doubled_radius = doubled_radius
        self.sa1_radius = sa1_radius * (2 if doubled_radius else 1)
        self.sa2_radius = sa2_radius * (2 if doubled_radius else 1)
        self.max_neighbors = max_neighbors
        self.fast_group, self.fast_fps = fast_group, fast_fps
        self.exact_selection = exact_selection
        self.split_first_layer = split_first_layer
        self.fused_sa = fused_sa
        self.compute_dtype = compute_dtype
        nm = neuron_multiplier if neuron_multiplier != 0 else 1
        f = num_features if num_features else 3  # no features: coordinates stand in
        act = activation_function
        common = dict(act=act, max_neighbors=max_neighbors, compute_dtype=compute_dtype,
                      fast_fps=fast_fps, exact_selection=exact_selection,
                      split_first_layer=split_first_layer, fused_sa=fused_sa)
        self.sa1 = SAModule(sa1_ratio, self.sa1_radius, [3 + f, 64 * nm, 64 * nm, 128 * nm],
                            fast_group=fast_group, **common)
        self.sa2 = SAModule(sa2_ratio, self.sa2_radius,
                            [128 * nm + 3, 128 * nm, 128 * nm, 256 * nm], **common)
        self.sa3 = GlobalSAModule([256 * nm + 3, 256 * nm, 512 * nm, 1024 * nm], act=act,
                                  compute_dtype=compute_dtype)
        self.head = MLP([1024 * nm, 128 * nm, 128 * nm, 4], act=None,
                        compute_dtype=compute_dtype, dropout=dropout_probability)

    def forward(self, cloud, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, 4) float32 predictions. ``train=True``: batch statistics (and
        their running update) in every BatchNorm, and the head's dropout,
        which needs ``generator``; FPS starts are drawn from ``generator``
        when one is given."""
        feat, pos, mask = cloud.feat, cloud.pos, cloud.mask
        if self.num_features == 0:
            feat = pos  # the reference: x = coords when no columns are used
        h, pos, mask = self.sa1(feat, pos, mask, train=train, generator=generator)
        h, pos, mask = self.sa2(h, pos, mask, train=train, generator=generator)
        h = self.sa3(h, pos, mask, train=train)
        return self.head(h, None, train, generator).float()  # predictions always float32


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_to_dict(model: PointNet2Regressor) -> dict:
    """JSON-serializable constructor arguments, under the JAX package's names
    (``dl_biomass_tpu/models/pointnet2.py`` model_to_dict), for the
    checkpoint sidecar."""
    div = 2 if model.doubled_radius else 1
    return dict(
        num_features=model.num_features,
        activation_function=model.activation_function,
        neuron_multiplier=model.neuron_multiplier,
        dropout_probability=model.dropout_probability,
        sa1_ratio=model.sa1_ratio,
        sa1_radius=model.sa1_radius / div,
        sa2_ratio=model.sa2_ratio,
        sa2_radius=model.sa2_radius / div,
        max_neighbors=model.max_neighbors,
        doubled_radius=model.doubled_radius,
        msg=False,
        remat=False,
        fast_group=model.fast_group,
        fast_fps=model.fast_fps,
        fused_sa=model.fused_sa,
        exact_selection=model.exact_selection,
        analytic_bn=False,
        split_first_layer=model.split_first_layer,
        num_outputs=4,
        global_width_mult=1,
        compute_dtype="bfloat16" if model.compute_dtype == torch.bfloat16 else "float32",
    )


def build_model(cfg, num_features: int) -> PointNet2Regressor:
    """The regressor from a ``TrainConfig`` (hp + model sections)."""
    hp, mc = cfg.hp, cfg.model
    unported = [name for name in ("msg", "analytic_bn", "remat") if getattr(mc, name)]
    if mc.family != "pointnet2" or unported:
        raise NotImplementedError(
            f"not ported yet (ROADMAP A.10, model variants): family={mc.family!r}, options "
            f"{unported}")
    return PointNet2Regressor(
        num_features=num_features,
        activation_function=hp.activation_function,
        neuron_multiplier=hp.neuron_multiplier,
        dropout_probability=hp.dropout_probability,
        sa1_ratio=mc.sa1_ratio,
        sa1_radius=mc.sa1_radius,
        sa2_ratio=mc.sa2_ratio,
        sa2_radius=mc.sa2_radius,
        max_neighbors=mc.max_neighbors,
        doubled_radius=mc.doubled_radius,
        fast_group=mc.fast_group,
        fast_fps=mc.fast_fps,
        exact_selection=mc.exact_selection,
        split_first_layer=mc.split_first_layer,
        fused_sa=mc.fused_sa,
        compute_dtype=_DTYPES[mc.compute_dtype],
    )
