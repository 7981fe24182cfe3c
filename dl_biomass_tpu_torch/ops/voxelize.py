"""Dense voxel grids from dense point clouds (port of ``dl_biomass_tpu/ops/voxelize.py``).

``voxelize`` scatters each cloud's valid points into a dense ``(B, G, G, G, C)``
grid once; the voxel model (``models/voxelnet.py``) then runs dense 3-D
convolutions over it. ``voxel_select_first`` is the on-device voxel-grid
downsampling of the density pipeline: the first valid point of each occupied
voxel, as ``io/resample.voxel_downsample`` picks it on the host.

Neither is a Pallas kernel in the JAX package (XLA scatters and sorts); here
they are PyTorch's ``index_add_`` and a stable ``torch.sort``. Differentiable
in the features (the scatter-add's gradient is a gather); voxel indices carry
no gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# the key of an invalid point in voxel_select_first: behind every voxel's key
_NO_KEY = torch.iinfo(torch.int64).max


def voxelize(pos: torch.Tensor, feat: Optional[torch.Tensor], mask: torch.Tensor, *,
             grid: int, extent: Optional[float] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter points into a dense voxel grid.

    The cube ``[-extent, extent]³`` is split into ``grid³`` voxels; points
    outside it are clipped onto the boundary voxels. ``extent=None`` adapts
    per cloud to the largest |coordinate| over its valid points (clouds arrive
    centred). pos (B, N, 3) float32, feat (B, N, F) or None, mask (B, N) bool.

    Returns float32:
      counts:   (B, G, G, G)    points per voxel (exact: whole numbers);
      feat_sum: (B, G, G, G, F) per-voxel feature sums (F = 0 without features);
      off_sum:  (B, G, G, G, 3) per-voxel sums of each point's offset from its
                voxel's centre, in voxel units.
    The sums are float32 additions in the order the scatter meets the points:
    on the card, atomics whose order may change between runs, so their last
    bits may too; the counts are exact in any order.
    """
    b, n, _ = pos.shape
    g3 = grid ** 3
    maskf = mask.float()
    # pads may hold anything: a where, not a multiply, keeps them out of the math
    posv = torch.where(mask[..., None], pos.float(), 0.0)
    if extent is None:
        ext = posv.abs().amax(dim=(1, 2))
        ext = torch.clamp_min(ext, 1e-6) * (1.0 + 1e-6)  # keeps the largest point inside
        ext = ext[:, None, None]
    else:
        ext = torch.full((b, 1, 1), float(extent), dtype=torch.float32, device=pos.device)

    u = (posv + ext) * (grid / 2.0) / ext  # in [0, grid) inside the cube
    iv = torch.clamp(u.to(torch.int64), 0, grid - 1)  # truncation, as JAX's int32 cast
    flat = (iv[..., 0] * grid + iv[..., 1]) * grid + iv[..., 2]
    flat = torch.where(mask, flat, 0)  # pads add zero weight to voxel 0
    rows = (flat + torch.arange(b, device=pos.device)[:, None] * g3).reshape(-1)

    counts = torch.zeros(b * g3, dtype=torch.float32, device=pos.device)
    counts.index_add_(0, rows, maskf.reshape(-1))
    f = 0 if feat is None else feat.shape[-1]
    if f:
        src = (feat.float() * maskf[..., None]).reshape(-1, f)
        fs = torch.zeros(b * g3, f, dtype=torch.float32, device=pos.device).index_add(
            0, rows, src)
    else:
        fs = torch.zeros(b * g3, 0, dtype=torch.float32, device=pos.device)
    off = torch.clamp(u - (iv.float() + 0.5), -0.5, 0.5) * maskf[..., None]
    os_ = torch.zeros(b * g3, 3, dtype=torch.float32, device=pos.device)
    os_.index_add_(0, rows, off.reshape(-1, 3))

    shape = (b, grid, grid, grid)
    return counts.view(shape), fs.view(*shape, f), os_.view(*shape, 3)


def voxelize_reference(pos, feat, mask, *, grid, extent=None):
    """Pure-numpy oracle with identical semantics (for parity tests), copied
    from the JAX package."""
    pos = np.asarray(pos, np.float32)  # f32 index math matches the tensor path
    mask = np.asarray(mask, bool)
    b, n, _ = pos.shape
    f = 0 if feat is None else np.asarray(feat).shape[-1]
    counts = np.zeros((b, grid, grid, grid), np.float64)
    fs = np.zeros((b, grid, grid, grid, f), np.float64)
    os_ = np.zeros((b, grid, grid, grid, 3), np.float64)
    for i in range(b):
        if extent is None:
            valid = pos[i][mask[i]]
            ext = max(float(np.abs(valid).max()) if len(valid) else 0.0, 1e-6)
            ext *= 1.0 + 1e-6
        else:
            ext = float(extent)
        for j in range(n):
            if not mask[i, j]:
                continue
            u = (pos[i, j] + ext) * (grid / 2.0) / ext
            iv = np.clip(u.astype(np.int32), 0, grid - 1)
            counts[i, iv[0], iv[1], iv[2]] += 1.0
            if f:
                fs[i, iv[0], iv[1], iv[2]] += np.asarray(feat)[i, j]
            os_[i, iv[0], iv[1], iv[2]] += np.clip(u - (iv + 0.5), -0.5, 0.5)
    return counts, fs, os_


def voxel_select_first(pos: torch.Tensor, mask: torch.Tensor, *, voxel_size: float,
                       n_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-device voxel-grid downsampling: the first valid point (by index) of
    each occupied voxel, kept in ascending index order, so that truncation to
    ``n_keep`` is the host path's ``kept[:n]`` (``io/resample.voxel_downsample``).

    pos (B, N, 3) float32, mask (B, N) bool -> ``(idx, out_mask)``: idx
    (B, min(N, n_keep)) int64 gather indices, out_mask False on the slots past
    the cloud's representative count.

    The voxel key packs the three voxel coordinates into an int64, which holds
    any plot a float32 coordinate can hold at any voxel size above a
    millimetre; the JAX package packs an int32, which wraps past about 450 m an
    axis at 0.35 m voxels (ROADMAP C.1). Inside that envelope both give the
    same picks. The quantization is float32 (``floor(pos / voxel_size)``) where
    the host path's may be float64: the two agree whenever the coordinates are
    float32 values, which is what the pipeline feeds.
    """
    q = torch.floor(pos / voxel_size).to(torch.int64)
    big = torch.iinfo(torch.int64).max // 4
    qmin = torch.where(mask[..., None], q, big).amin(dim=1, keepdim=True)
    q = q - qmin
    span = torch.where(mask[..., None], q, -1).amax(dim=1) + 1  # (B, 3)
    key = (q[..., 0] * span[:, 1:2] + q[..., 1]) * span[:, 2:3] + q[..., 2]
    key = torch.where(mask, key, _NO_KEY)  # behind every voxel, never a voxel's
    ks, order = torch.sort(key, dim=1, stable=True)  # by voxel, then by index
    first = torch.ones_like(ks, dtype=torch.bool)
    first[:, 1:] = ks[:, 1:] != ks[:, :-1]
    first &= ks != _NO_KEY
    rep = torch.zeros_like(first).scatter_(1, order, first)
    # representatives first, in index order (a stable sort of "not a representative")
    sel = torch.sort((~rep).to(torch.uint8), dim=1, stable=True).indices[:, :n_keep]
    return sel, rep.gather(1, sel)
