"""Kernel 3: exact ball query, the first K in-radius neighbours by index.

Semantics of ``dl_biomass_tpu/ops/ballquery.py`` ball_query(method="exact"):
for a valid centroid, the K smallest indices of valid points with squared
distance <= r^2 (inclusive), ascending; the other slots hold 0 and are masked
off. Unlike the Pallas kernel it replaces (``pallas_ballquery.py``), which
drops neighbours when one residue bucket holds more than 8 of the first 64,
both versions here are exact.

``ball_query_first_k`` launches ``csrc/ball_query.cu`` on a CUDA tensor and
runs ``ball_query_plain`` on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from dl_biomass_tpu_torch.ops import _build
from dl_biomass_tpu_torch.ops.grouping import in_radius

CHUNK = 256  # centroids per block of the plain version
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]


def _radius2(radius: float) -> float:
    # the jnp exact path squares the radius in f32
    r = np.float32(radius)
    return float(r * r)


def _check(centers, center_mask, pos, mask, k):
    b, m, _ = centers.shape
    n = pos.shape[1]
    if centers.dtype != torch.float32 or pos.dtype != torch.float32:
        raise ValueError("centers and pos must be float32")
    if tuple(center_mask.shape) != (b, m) or tuple(mask.shape) != (b, n):
        raise ValueError("center_mask must be (B, M) and mask (B, N)")
    if k < 1:
        raise ValueError(f"k={k} must be positive")


def ball_query_plain(centers, center_mask, pos, mask, *, radius: float, k: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, chunked over centroids: the first K keys of
    each (chunk, N) block by ``topk`` over index-or-sentinel keys."""
    _check(centers, center_mask, pos, mask, k)
    b, m, _ = centers.shape
    n = pos.shape[1]
    dev = pos.device
    r2 = _radius2(radius)
    k_eff = min(k, n)
    order = torch.arange(n, device=dev)
    idx = torch.zeros((b, m, k), dtype=torch.int32, device=dev)
    nbr_mask = torch.zeros((b, m, k), dtype=torch.bool, device=dev)
    for s in range(0, m, CHUNK):
        c = centers[:, s:s + CHUNK]
        mc = c.shape[1]
        ok = in_radius(c, center_mask[:, s:s + CHUNK], pos, mask, r2)
        keys = torch.where(ok, order, n)
        first = keys.topk(k_eff, dim=-1, largest=False, sorted=True).values
        valid = first < n
        idx[:, s:s + mc, :k_eff] = torch.where(valid, first, 0).to(torch.int32)
        nbr_mask[:, s:s + mc, :k_eff] = valid
    return idx, nbr_mask


def ball_query_first_k(centers: torch.Tensor, center_mask: torch.Tensor, pos: torch.Tensor,
                       mask: torch.Tensor, *, radius: float, k: int = 64
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """centers (B, M, 3), center_mask (B, M), pos (B, N, 3), mask (B, N) ->
    idx (B, M, K) int32 (0 where invalid), nbr_mask (B, M, K) bool.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if pos.device.type == "cpu":
        return ball_query_plain(centers, center_mask, pos, mask, radius=radius, k=k)
    if pos.device.type != "cuda":
        raise RuntimeError(f"ball_query runs on cuda or cpu tensors, got {pos.device}")
    _check(centers, center_mask, pos, mask, k)
    b, m, _ = centers.shape
    n = pos.shape[1]
    planes = pos.transpose(1, 2).contiguous()  # (B, 3, N)
    centers, center_mask, mask = centers.contiguous(), center_mask.contiguous(), mask.contiguous()
    _build.check_cuda("ball_query", centers, center_mask, planes, mask)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=pos.device)
    nbr_mask = torch.empty((b, m, k), dtype=torch.bool, device=pos.device)
    _build.launch("dlbt_ball_query", _ARGTYPES, centers.data_ptr(), center_mask.data_ptr(),
                  planes.data_ptr(), mask.data_ptr(), idx.data_ptr(), nbr_mask.data_ptr(),
                  b, m, n, k, _radius2(radius), _build.stream_of(pos))
    return idx, nbr_mask

