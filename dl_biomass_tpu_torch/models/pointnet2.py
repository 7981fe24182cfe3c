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

The variants (JAX ``pointnet2.py``): ``msg`` groups every SA layer at its
radius and at twice it from one FPS, each scale with its own MLP (``mlp``,
``mlp1``), and concatenates them, so SA2's and SA3's inputs double;
``analytic_bn`` runs every MLP in the folded form (``layers.MLP``), which
turns SA2's split first layer off (kernel 4c gathers the edges);
``remat`` recomputes the SA layers' unfused MLPs in the backward;
``num_outputs`` and ``global_width_mult`` (``pointnet2_v2``: one output, SA3
and the head twice as wide) size the end of the network. ``model_to_dict``,
``model_from_dict`` and ``build_model`` also take the voxel family
(``models/voxelnet.py``) and the per-point segmentor (``models/decoder.py``),
which refuses the options it does not take (``SEGMENTOR_REFUSES``).

Under ``parallel.data_parallel(mesh, points=True)`` with ``mp`` > 1 each rank
holds its ``mp`` slice of every cloud's points (``mesh.shard_points``), as a
batch placed with ``P("dp", "mp", None)`` in the JAX package; the forward
writes out what XLA does there. SA1 gathers the slices (the cloud is small
beside the edges) and every ``mp`` rank runs FPS on the whole cloud, from
the same draws; SA1 and SA2 then split by centroid (``_Share``): each rank
groups, gathers and runs the MLP and the max for its share of the centroids
alone, its BatchNorm statistics summed over the whole mesh; SA2's z-table
(or its features) comes from each rank's own SA1 rows, gathered over ``mp``
before kernel 4 reads it; SA3 and the head run on the gathered SA2 rows,
replicated over ``mp``. The gathers' backward sums the cotangents over
``mp``, so a rank's rows get every rank's share. A ``fused_sa`` model
gathers the points and runs replicated, as XLA runs a Pallas call it cannot
partition.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
from torch import nn

from dl_biomass_tpu_torch.models.layers import MLP, FusedSAMLP, dot_f32
from dl_biomass_tpu_torch.models.voxelnet import VoxelNet
from dl_biomass_tpu_torch.ops import ball_group_kernel, gather_kernel
from dl_biomass_tpu_torch.ops.ballquery import ball_query
from dl_biomass_tpu_torch.ops.fps import farthest_point_sample, fps_sectored
from dl_biomass_tpu_torch.ops.grouping import (edges_from_gathered, gather_points,
                                             group_neighborhoods)
from dl_biomass_tpu_torch.ops.pooling import masked_max
from dl_biomass_tpu_torch.parallel import mesh as dp
from dl_biomass_tpu_torch.utils import profiling

# the JAX package gathers SA2's z-table with its one-hot kernel only while the
# table (SA1's centroids) holds at most this many rows (pointnet2.py:172,
# inference.py:233); beyond it the edges are gathered unsplit
MXU_MAX_POINTS = 4096
# the activations kernel 6 computes; under fused_sa any other keeps the unfused MLP
FUSED_SA_ACTS = (None, "None", "ReLU", "LeakyReLU", "ELU")


class _Share:
    """This rank's share of ``n`` rows (dim 1) split over the ``mp`` ranks of
    the active mesh: rows [lo, lo + size), size = ceil(n / mp), the last
    share padded past ``n``."""

    def __init__(self, n: int):
        mesh = dp.active()
        self.n, self.mesh = n, mesh
        self.size = -(-n // dp.mp_size(mesh))
        self.lo = dp.mp_rank(mesh) * self.size

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This share's rows of ``t`` (B, n, ...), zeros (False) past ``n``."""
        part = t[:, self.lo:self.lo + self.size]
        pad = self.size - part.shape[1]
        if pad:
            part = torch.cat([part, part.new_zeros((part.shape[0], pad, *part.shape[2:]))], 1)
        return part

    def full(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t`` (B, size, ...) in order, the first ``n``;
        differentiable."""
        return dp.gather_mp(t, self.mesh, self.n)


def count_edges(nbr_mask: torch.Tensor) -> None:
    """While spans are recorded: the counters ``edges.valid`` (neighbour
    slots that hold a neighbour) and ``edges.slots`` (all slots, pads
    included) of one scale's neighbourhoods."""
    if profiling.enabled():
        profiling.count("edges.valid", nbr_mask.sum())
        profiling.count("edges.slots", nbr_mask.numel())


def sample_centroids(pos, mask, m: int, *, sectored: bool, generator=None):
    """FPS (sectored or exact; random starts from ``generator``, else the first
    valid point) -> (idx, centers, center_mask)."""
    fps = fps_sectored if sectored else farthest_point_sample
    idx = fps(pos, mask, m, generator=generator)
    centers = gather_points(pos, idx)
    center_mask = mask.gather(1, idx.long())
    return idx, centers, center_mask


class SAModule(nn.Module):
    """Set-abstraction layer: FPS -> neighbours -> grouped pointwise MLP -> max,
    at ``radius`` and at each of ``extra_radii`` (MSG) from one FPS, the
    scales' outputs concatenated."""

    def __init__(self, ratio: float, radius: float, mlp_channels: Sequence[int],
                 act: Optional[str] = "ReLU", max_neighbors: int = 64,
                 compute_dtype: torch.dtype = torch.float32, fast_group: bool = False,
                 fast_fps: bool = False, exact_selection: bool = False,
                 split_first_layer: bool = True, fused_sa: bool = False,
                 extra_radii: Sequence[float] = (), analytic_bn: bool = False,
                 remat: bool = False):
        super().__init__()
        self.ratio, self.radius = ratio, radius
        self.radii = (radius, *extra_radii)
        self.max_neighbors = max_neighbors
        self.compute_dtype = compute_dtype
        self.fast_group, self.fast_fps = fast_group, fast_fps
        self.exact_selection = exact_selection
        self.split_first_layer = split_first_layer
        self.analytic_bn = analytic_bn
        # the JAX package's use_fused_sa: kernel 6 takes K=64, two hidden layers
        # and its four activations
        self.fused_sa = (fused_sa and max_neighbors == 64 and len(mlp_channels) == 4
                         and act in FUSED_SA_ACTS)
        for i in range(len(self.radii)):  # the flax names: mlp, mlp1, ...
            mlp = (FusedSAMLP(mlp_channels, act=act, compute_dtype=compute_dtype)
                   if self.fused_sa else
                   MLP(mlp_channels, act=act, compute_dtype=compute_dtype,
                       analytic_bn=analytic_bn, remat=remat))
            setattr(self, f"mlp{i}" if i else "mlp", mlp)

    def mlps(self):
        return [getattr(self, f"mlp{i}" if i else "mlp") for i in range(len(self.radii))]

    def forward(self, feat, pos, mask, *, train: bool = False, generator=None, rows=None,
                split: bool = False):
        """(features of the centroids, centroids (B, M, 3), their mask).
        ``split`` (points over ``mp``): only this rank's share of the
        centroids is computed and its rows returned (padded), with that share
        (``_Share``) as a fourth item; ``rows``, the share of ``pos`` whose
        features ``feat`` holds (None: ``feat`` holds every row)."""
        m = math.ceil(self.ratio * pos.shape[1])
        _, centers, center_mask = sample_centroids(
            pos, mask, m, sectored=self.fast_fps and not self.exact_selection,
            generator=generator)
        mine, mine_mask, share = centers, center_mask, None
        if split:
            share = _Share(m)
            mine, mine_mask = share.take(centers), share.take(center_mask)
        with dp.split_rows() if split else contextlib.nullcontext():
            outs = [self._one_scale(mlp, r, feat, pos, mask, mine, mine_mask, train, rows)
                    for r, mlp in zip(self.radii, self.mlps())]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        return (out, centers, center_mask) + ((share,) if split else ())

    def _one_scale(self, mlp, radius, feat, pos, mask, centers, center_mask, train, rows=None):
        n = pos.shape[1]
        cdt = self.compute_dtype
        full = (lambda t: t) if rows is None else rows.full
        if (self.fast_group and not self.exact_selection and self.max_neighbors == 64
                and (feat is None or feat.shape[-1] <= 4)):
            _, nbr_mask, edges = ball_group_kernel.ball_group(
                centers, center_mask, pos, mask, feat, radius=radius,
                out_dtype=torch.float32 if self.fused_sa else cdt, need_idx=False)
            count_edges(nbr_mask)
            if self.fused_sa:  # the float32 edges [feat, rel] are kernel 6's planes
                return mlp(None, edges, nbr_mask, train)
            return masked_max(mlp(edges.detach(), nbr_mask, train), nbr_mask, dim=2)

        nbr_idx, nbr_mask = ball_query(centers, center_mask, pos, mask, radius=radius,
                                       k=self.max_neighbors)
        count_edges(nbr_mask)
        use_mxu = (feat is not None and feat.shape[-1] >= 16 and n <= MXU_MAX_POINTS
                   and self.max_neighbors == 64)
        if use_mxu and self.split_first_layer and not (self.fused_sa or self.analytic_bn):
            # layer 0 is linear in [x_j, p_j - p_i]: z0 = (Wf x_j + Wp p_j + b0) - Wp p_i
            # runs once per point, and kernel 4 gathers the z-table. Each use
            # casts wp on its own, as JAX does, so the two bf16 gradients of
            # wp meet in float32
            # (split over mp: each rank's own rows, gathered)
            lin0 = mlp.lin0
            w0 = lin0.weight.t()
            fdim = feat.shape[-1]
            wf, wp = w0[:fdim], w0[fdim:]
            own = pos if rows is None else rows.take(pos)
            zpt = full((dot_f32(feat.to(cdt), wf.to(cdt)) + dot_f32(own.to(cdt), wp.to(cdt))
                        + lin0.bias).to(cdt))
            gz = gather_kernel.gather_rows(zpt, nbr_idx)
            cshift = dot_f32(centers.to(cdt), wp.to(cdt))
            z0 = gz - cshift[:, :, None, :].to(gz.dtype)
            return masked_max(mlp.from_z0(z0, nbr_mask, train), nbr_mask, dim=2)
        feat = full(feat)
        if use_mxu:
            # features (differentiable) and positions (the gradient-free aux
            # table) gathered by one index, kernel 4c
            gfeat, gpos = gather_kernel.gather_rows(feat, nbr_idx, aux=pos)
            if self.fused_sa:  # dense: the masked features; planes: p_j - c_i
                dense = torch.where(nbr_mask[..., None], gfeat,
                                    torch.zeros((), dtype=gfeat.dtype, device=gfeat.device))
                return mlp(dense, gpos - centers[:, :, None, :], nbr_mask, train)
            grouped = edges_from_gathered(gfeat, gpos, centers, nbr_mask)
        else:
            grouped = group_neighborhoods(pos, feat, centers, nbr_idx, nbr_mask)
            if self.fused_sa:
                return mlp(grouped, None, nbr_mask, train)
        return masked_max(mlp(grouped, nbr_mask, train), nbr_mask, dim=2)


class GlobalSAModule(nn.Module):
    """Global set abstraction: MLP over [feat, pos], then a masked global max."""

    def __init__(self, mlp_channels: Sequence[int], act: Optional[str] = "ReLU",
                 compute_dtype: torch.dtype = torch.float32, analytic_bn: bool = False):
        super().__init__()
        self.mlp = MLP(mlp_channels, act=act, compute_dtype=compute_dtype,
                       analytic_bn=analytic_bn)

    def forward(self, feat, pos, mask, *, train: bool = False):
        return masked_max(self.mlp(torch.cat([feat, pos], dim=-1), mask, train), mask, dim=1)


class PointNet2Regressor(nn.Module):
    """The reference ``Net(num_features, activation_function,
    neuron_multiplier, dropout_probability)``, with the JAX package's knobs."""

    def __init__(self, num_features: int, activation_function: str = "ReLU",
                 neuron_multiplier: int = 0, dropout_probability: float = 0.5,
                 sa1_ratio: float = 0.2, sa1_radius: float = 2.0, sa2_ratio: float = 0.25,
                 sa2_radius: float = 8.0, max_neighbors: int = 64,
                 doubled_radius: bool = False, msg: bool = False, remat: bool = False,
                 fast_group: bool = False, fast_fps: bool = False, fused_sa: bool = False,
                 exact_selection: bool = False, analytic_bn: bool = False,
                 split_first_layer: bool = True, num_outputs: int = 4,
                 global_width_mult: int = 1, compute_dtype: torch.dtype = torch.float32):
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
        self.msg, self.remat, self.analytic_bn = msg, remat, analytic_bn
        self.fast_group, self.fast_fps = fast_group, fast_fps
        self.exact_selection = exact_selection
        self.split_first_layer = split_first_layer
        self.fused_sa = fused_sa
        self.num_outputs, self.global_width_mult = num_outputs, global_width_mult
        self.compute_dtype = compute_dtype
        nm = neuron_multiplier if neuron_multiplier != 0 else 1
        f = num_features if num_features else 3  # no features: coordinates stand in
        act = activation_function
        sa_mult = 2 if msg else 1  # MSG concatenates two scales
        gw = global_width_mult
        common = dict(act=act, max_neighbors=max_neighbors, compute_dtype=compute_dtype,
                      fast_fps=fast_fps, exact_selection=exact_selection,
                      split_first_layer=split_first_layer, fused_sa=fused_sa,
                      analytic_bn=analytic_bn, remat=remat)
        self.sa1 = SAModule(sa1_ratio, self.sa1_radius, [3 + f, 64 * nm, 64 * nm, 128 * nm],
                            fast_group=fast_group,
                            extra_radii=(2 * self.sa1_radius,) if msg else (), **common)
        self.sa2 = SAModule(sa2_ratio, self.sa2_radius,
                            [128 * nm * sa_mult + 3, 128 * nm, 128 * nm, 256 * nm],
                            extra_radii=(2 * self.sa2_radius,) if msg else (), **common)
        self.sa3 = GlobalSAModule([256 * nm * sa_mult + 3, 256 * nm, 512 * nm, 1024 * nm * gw],
                                  act=act, compute_dtype=compute_dtype, analytic_bn=analytic_bn)
        self.head = MLP([1024 * nm * gw, 128 * nm * gw, 128 * nm * gw, num_outputs], act=None,
                        compute_dtype=compute_dtype, dropout=dropout_probability,
                        analytic_bn=analytic_bn)

    def forward(self, cloud, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, num_outputs) float32 predictions. ``train=True``: batch
        statistics (and their running update) in every BatchNorm, and the
        head's dropout, which needs ``generator``; FPS starts are drawn from
        ``generator`` when one is given."""
        feat, pos, mask = cloud.feat, cloud.pos, cloud.mask
        dev = pos.device
        split = dp.point_parts() > 1
        if split:  # this rank's mp slice of the points: SA1 reads whole clouds
            pos, feat, mask = (dp.gather_points(t, dp.active()) for t in (pos, feat, mask))
            split = not self.fused_sa  # kernel 6 runs replicated over mp
        if self.num_features == 0:
            feat = pos  # the reference: x = coords when no columns are used
        if split:
            with profiling.span("model.sa1", device=dev):
                h, pos, mask, rows = self.sa1(feat, pos, mask, train=train,
                                              generator=generator, split=True)
            with profiling.span("model.sa2", device=dev):
                h, pos, mask, rows = self.sa2(h, pos, mask, train=train, generator=generator,
                                              rows=rows, split=True)
                h = rows.full(h)
        else:
            with profiling.span("model.sa1", device=dev):
                h, pos, mask = self.sa1(feat, pos, mask, train=train, generator=generator)
            with profiling.span("model.sa2", device=dev):
                h, pos, mask = self.sa2(h, pos, mask, train=train, generator=generator)
        with profiling.span("model.sa3", device=dev):
            h = self.sa3(h, pos, mask, train=train)
        with profiling.span("model.head", device=dev):
            return self.head(h, None, train, generator).float()  # predictions always float32


def pointnet2_v2(num_features: int, activation_function: str = "ReLU") -> PointNet2Regressor:
    """The reference's historical V2 variant: one (scalar biomass) output, SA3's
    output and the head's hidden widths doubled (``Misc/pn2_regressor_V2.py:35-53``)."""
    return PointNet2Regressor(num_features=num_features,
                              activation_function=activation_function, num_outputs=1,
                              global_width_mult=2)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype_name(dt: torch.dtype) -> str:
    return "bfloat16" if dt == torch.bfloat16 else "float32"


# the ModelConfig switches the segmentor does not take, each refused when set,
# and the mesh's mp (its decoder runs on whole clouds)
SEGMENTOR_REFUSES = ("msg", "remat", "fused_sa", "analytic_bn", "doubled_radius")
_SEGMENTOR_ARGS = ("sa1_ratio", "sa1_radius", "sa2_ratio", "sa2_radius", "max_neighbors",
                   "fast_group", "fast_fps", "exact_selection", "split_first_layer")


def _segmentor_class():
    from dl_biomass_tpu_torch.models.decoder import PointNet2Segmentor  # imports this module

    return PointNet2Segmentor


def model_to_dict(model) -> dict:
    """JSON-serializable constructor arguments, under the JAX package's names
    (``dl_biomass_tpu/models/pointnet2.py`` model_to_dict, less its kernel
    switch ``use_pallas``), for the checkpoint sidecar; a voxel model's and a
    segmentor's carry ``family``."""
    if isinstance(model, _segmentor_class()):
        return dict(family="segmentor", num_features=model.num_features,
                    activation_function=model.activation_function,
                    num_outputs=model.num_outputs,
                    dropout_probability=model.dropout_probability,
                    **{k: getattr(model, k) for k in _SEGMENTOR_ARGS},
                    compute_dtype=_dtype_name(model.compute_dtype))
    if isinstance(model, VoxelNet):
        return dict(family="voxelnet", num_features=model.num_features,
                    num_outputs=model.num_outputs, grid=model.grid, extent=model.extent,
                    channels=list(model.channels),
                    activation_function=model.activation_function,
                    compute_dtype=_dtype_name(model.compute_dtype))
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
        msg=model.msg,
        remat=model.remat,
        fast_group=model.fast_group,
        fast_fps=model.fast_fps,
        fused_sa=model.fused_sa,
        exact_selection=model.exact_selection,
        analytic_bn=model.analytic_bn,
        split_first_layer=model.split_first_layer,
        num_outputs=model.num_outputs,
        global_width_mult=model.global_width_mult,
        compute_dtype=_dtype_name(model.compute_dtype),
    )


def model_from_dict(d: dict):
    """The model from ``model_to_dict``'s arguments (a checkpoint sidecar's
    ``"model"``), dispatched on ``family`` (absent: ``pointnet2``)."""
    d = dict(d)
    family = d.pop("family", "pointnet2")
    d["compute_dtype"] = _DTYPES[d.get("compute_dtype", "float32")]
    if family == "voxelnet":
        d["channels"] = tuple(d.get("channels", (64, 128)))
        return VoxelNet(**d)
    if family == "segmentor":
        return _segmentor_class()(**d)
    if family != "pointnet2":
        raise ValueError(f"unknown model family {family!r}")
    return PointNet2Regressor(**d)


def build_model(cfg, num_features: int):
    """The model of a ``TrainConfig`` (hp + model sections): the regressor, the
    voxel CNN under ``model.family = "voxelnet"``, or the per-point segmentor
    under ``"segmentor"`` (one output a point; a ``ValueError`` names the
    options it does not take)."""
    hp, mc = cfg.hp, cfg.model
    if mc.family == "voxelnet":
        return VoxelNet(num_features=num_features, grid=mc.voxel_grid, extent=mc.voxel_extent,
                        channels=tuple(mc.voxel_channels),
                        activation_function=hp.activation_function,
                        compute_dtype=_DTYPES[mc.compute_dtype])
    if mc.family == "segmentor":
        refused = [k for k in SEGMENTOR_REFUSES if getattr(mc, k)]
        refused += ["hp.neuron_multiplier"] if hp.neuron_multiplier not in (0, 1) else []
        refused += ["mesh.mp > 1"] if cfg.mesh.mp > 1 else []
        if refused:
            raise ValueError(f"the segmentor family does not take {', '.join(refused)}")
        return _segmentor_class()(
            num_features=num_features, activation_function=hp.activation_function,
            dropout_probability=hp.dropout_probability,
            **{k: getattr(mc, k) for k in _SEGMENTOR_ARGS},
            compute_dtype=_DTYPES[mc.compute_dtype])
    if mc.family != "pointnet2":
        raise ValueError(f"unknown model family {mc.family!r}")
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
        msg=mc.msg,
        remat=mc.remat,
        fast_group=mc.fast_group,
        fast_fps=mc.fast_fps,
        fused_sa=mc.fused_sa,
        exact_selection=mc.exact_selection,
        analytic_bn=mc.analytic_bn,
        split_first_layer=mc.split_first_layer,
        compute_dtype=_DTYPES[mc.compute_dtype],
    )


def seeded_init(seed: int, build, *args, **kwargs) -> PointNet2Regressor:
    """``build(*args, **kwargs)`` (``build_model``, ``model_from_dict``, the
    class) with its initial weights drawn from ``seed``: the CPU generator,
    where the modules are built, is seeded in a fork, so the caller's random
    state is left as it was. The weights of ``torch.manual_seed(seed)`` then
    ``build`` (the ``train`` command's)."""
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(int(seed))
        return build(*args, **kwargs)
