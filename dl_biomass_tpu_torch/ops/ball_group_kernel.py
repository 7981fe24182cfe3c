"""Kernel 2: stratified ball query fused with the capture of the edge features.

Selection rule (``dl_biomass_tpu/ops/pallas_group.py`` stratified_pair_select):
points fall into 128 residue buckets (index mod 128), and output slot j of 64
holds the smallest in-radius valid index whose residue is j or j + 64. The
captured edge row is ``[feat_j, pos_j - center_i]`` in the output type, zero
where the slot is invalid — the SA1 MLP input, with no gather outside.

``ball_group`` launches ``csrc/ball_group.cu`` on a CUDA tensor and runs
``ball_group_plain`` on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dl_biomass_tpu_torch.core.cloud import round_up
from dl_biomass_tpu_torch.ops import _build
from dl_biomass_tpu_torch.ops.grouping import in_radius

G = 128  # residue buckets
K = 64  # output slots
CHUNK = 128  # centroids per block of the plain version: (B, 128, N) fits at full size
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                          ctypes.c_void_p]


def _radius2(radius: float) -> float:
    # the Pallas kernel squares the radius in double and compares in f32
    return float(torch.tensor(float(radius) ** 2, dtype=torch.float32))


def _check(centers, center_mask, pos, mask, feat):
    b, m, _ = centers.shape
    n = pos.shape[1]
    if centers.dtype != torch.float32 or pos.dtype != torch.float32:
        raise ValueError("centers and pos must be float32")
    if tuple(center_mask.shape) != (b, m) or tuple(mask.shape) != (b, n):
        raise ValueError("center_mask must be (B, M) and mask (B, N)")
    if feat is not None and (feat.shape[:2] != pos.shape[:2] or feat.dtype != torch.float32):
        raise ValueError("feat must be (B, N, F) float32")


def ball_group_plain(centers, center_mask, pos, mask, feat=None, *, radius: float,
                     out_dtype=torch.float32, need_idx: bool = True):
    """The plain PyTorch version, chunked over centroids so that the (B, chunk,
    N) distance block fits memory at full size."""
    _check(centers, center_mask, pos, mask, feat)
    b, m, _ = centers.shape
    n = pos.shape[1]
    f = 0 if feat is None else feat.shape[-1]
    dev = pos.device
    r2 = _radius2(radius)
    n_pad = round_up(n, G)
    order = torch.arange(n, device=dev)
    table = pos if feat is None else torch.cat([feat, pos], dim=-1)  # (B, N, F+3)
    edges = torch.empty((b, m, K, f + 3), dtype=out_dtype, device=dev)
    nbr_mask = torch.empty((b, m, K), dtype=torch.bool, device=dev)
    idx = torch.empty((b, m, K), dtype=torch.int32, device=dev) if need_idx else None
    for s in range(0, m, CHUNK):
        c = centers[:, s:s + CHUNK]  # (B, mc, 3)
        mc = c.shape[1]
        ok = in_radius(c, center_mask[:, s:s + CHUNK], pos, mask, r2)
        keys = F.pad(torch.where(ok, order, n), (0, n_pad - n), value=n)
        bmin = keys.view(b, mc, n_pad // G, G).amin(dim=2)  # (B, mc, 128)
        pair = torch.minimum(bmin[..., :K], bmin[..., K:])  # (B, mc, 64)
        valid = pair < n
        sel = torch.where(valid, pair, 0)
        rows = table.gather(1, sel.reshape(b, -1, 1).expand(-1, -1, f + 3))
        rows = rows.reshape(b, mc, K, f + 3)
        rel = rows[..., f:] - c[:, :, None, :]
        e = torch.cat([rows[..., :f], rel], dim=-1).to(out_dtype)
        edges[:, s:s + mc] = torch.where(valid[..., None], e, torch.zeros((), dtype=out_dtype,
                                                                          device=dev))
        nbr_mask[:, s:s + mc] = valid
        if need_idx:
            idx[:, s:s + mc] = sel.to(torch.int32)
    return idx, nbr_mask, edges


def ball_group(centers: torch.Tensor, center_mask: torch.Tensor, pos: torch.Tensor,
               mask: torch.Tensor, feat: Optional[torch.Tensor] = None, *, radius: float,
               out_dtype=torch.float32, need_idx: bool = True
               ) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Stratified selection + capture.

    Returns ``idx`` (B, M, 64) int32 (0 where invalid; None unless
    ``need_idx``), ``nbr_mask`` (B, M, 64) bool and ``edges`` (B, M, 64, F+3)
    in ``out_dtype`` (bf16 or f32): ``[feat_j, pos_j - center_i]``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if pos.device.type == "cpu":
        return ball_group_plain(centers, center_mask, pos, mask, feat, radius=radius,
                                out_dtype=out_dtype, need_idx=need_idx)
    if pos.device.type != "cuda":
        raise RuntimeError(f"ball_group runs on cuda or cpu tensors, got {pos.device}")
    _check(centers, center_mask, pos, mask, feat)
    b, m, _ = centers.shape
    n = pos.shape[1]
    f = 0 if feat is None else feat.shape[-1]
    planes = pos.transpose(1, 2) if feat is None else torch.cat([pos, feat], -1).transpose(1, 2)
    planes = planes.contiguous()  # (B, 3+F, N): x, y, z, features
    centers, center_mask, mask = centers.contiguous(), center_mask.contiguous(), mask.contiguous()
    _build.check_cuda("ball_group", centers, center_mask, planes, mask)
    dev = pos.device
    edges = torch.empty((b, m, K, f + 3), dtype=out_dtype, device=dev)
    nbr_mask = torch.empty((b, m, K), dtype=torch.bool, device=dev)
    idx = torch.empty((b, m, K), dtype=torch.int32, device=dev) if need_idx else None
    _build.launch("dlbt_ball_group", _ARGTYPES, centers.data_ptr(), center_mask.data_ptr(),
                  planes.data_ptr(), mask.data_ptr(), edges.data_ptr(), nbr_mask.data_ptr(),
                  _build.ptr(idx), b, m, n, f, _radius2(radius),
                  int(out_dtype == torch.bfloat16), _build.stream_of(pos))
    return idx, nbr_mask, edges

