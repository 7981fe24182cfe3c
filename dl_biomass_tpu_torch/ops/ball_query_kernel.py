"""Kernel 3: exact ball query, the first K in-radius neighbours by index.

Semantics of ``dl_biomass_tpu/ops/ballquery.py`` ball_query(method="exact"):
for a valid centroid, the K smallest indices of valid points with squared
distance <= r^2 (inclusive), ascending; the other slots hold 0 and are masked
off. Unlike the Pallas kernel it replaces (``pallas_ballquery.py``), which
drops neighbours when one residue bucket holds more than 8 of the first 64,
both versions here are exact.

``ball_query_first_k`` calls the registered op
``torch.ops.dlbt.ball_query_first_k``, which launches ``csrc/ball_query.cu``
on a CUDA tensor and runs ``ball_query_plain`` on a CPU tensor (its fake
implementation gives shapes from shapes, for ``torch.export``).

``plan(n, m, k)`` names the launch for clouds of n points, m centroids and k
slots, mirroring the kernel's dispatch: the centroids a block, its warps, the
points staged in shared memory at once, whether the cloud is staged whole
(the warps then take the block's centroids from a shared counter) or a chunk
at a time (one centroid a warp), and the chunks of 32 points a warp tests
before it reads its hit count. ``probe`` (the kernel with no early exit,
with its staging alone, or with no writing) and ``occupancy`` measure the
kernel; no path calls them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import round_up
from dl_biomass_tpu_torch.ops import _build
from dl_biomass_tpu_torch.ops.grouping import in_radius

CHUNK = 256  # centroids per block of the plain version
# the kernel's instantiations (csrc/ball_query.cu): chunks of 32 points a warp
# tests before it reads its hit count. The plans below: at each SA2 shape of
# 7168 and 10240 points within 9% of the fastest plan swept, and the fastest
# at the parity preset's SA1 (chip_compare.py querytune on an H100; 21% off
# it at SA2 of 2 x 20608, whose two clouds want smaller tiles)
AHEADS = (4, 8)
AHEAD = 8
POINT_BYTES = 16  # one float4 a staged point
SLOT_BYTES = 4  # a warp's slots: k int32 in shared memory
SMEM_PER_BLOCK = 232448  # the shared memory a block may have on an H100 (227 KB)
STATIC_SMEM = 16  # the whole kernel's centroid counter, rounded up
MAX_THREADS = 1024
# where the padded cloud fits a block (whole), the warps and centroids a block
# where two blocks fit an SM's shared memory (SHARED), and where one fills it
# (ALONE); larger clouds are staged CHUNK_POINTS at a time, one centroid a warp
SHARED_WARPS, SHARED_CENTROIDS = 16, 32
ALONE_WARPS, ALONE_CENTROIDS = 32, 256
CHUNK_WARPS, CHUNK_POINTS = 32, 8192
MAX_POINTS = (2**31 - 1) // POINT_BYTES  # the kernel indexes points with 32-bit ints
# the kernel on every path, and the measurements: no early exit, the staging
# and the writing of the outputs alone, the scan without the writing
MODES = {"kernel": 0, "full_scan": 1, "stage_only": 2, "no_store": 3}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


class Plan(NamedTuple):
    centroids: int  # centroids a block (one a warp where chunked)
    warps: int  # warps a block
    points: int  # points staged in shared memory at once
    whole: bool  # the cloud staged whole (else a chunk of `points` at a time)
    ahead: int  # chunks of 32 points tested before the hit count is read


def plan(n: int, m: int, k: int) -> Optional[Plan]:
    """The launch for clouds of ``n`` points, ``m`` centroids and ``k``
    slots, or None where the kernel takes no such clouds."""
    if not (1 <= n <= MAX_POINTS and m >= 1 and k >= 1):
        return None
    n_pad = round_up(n, 32 * AHEAD)
    shared = Plan(SHARED_CENTROIDS, SHARED_WARPS, n_pad, True, AHEAD)
    if 2 * smem_bytes(shared, k) <= SMEM_PER_BLOCK:  # blocks share an SM
        return shared
    alone = Plan(ALONE_CENTROIDS, ALONE_WARPS, n_pad, True, AHEAD)
    if smem_bytes(alone, k) <= SMEM_PER_BLOCK:  # one block fills an SM
        return alone
    chunked = Plan(CHUNK_WARPS, CHUNK_WARPS, CHUNK_POINTS, False, AHEAD)
    return chunked if smem_bytes(chunked, k) <= SMEM_PER_BLOCK else None


def smem_bytes(p: Plan, k: int) -> int:
    """A block's shared memory: its staged points, each warp's k slots, and
    the whole kernel's counter."""
    return p.points * POINT_BYTES + p.warps * k * SLOT_BYTES + (STATIC_SMEM if p.whole else 0)


def launch_plan(n: int, m: int, k: int) -> Plan:
    """``plan(n, m, k)``, or ValueError where the kernel takes no such clouds."""
    p = plan(n, m, k)
    if p is None:
        raise ValueError(f"ball_query: the kernel takes no clouds of {n} points, {m} centroids "
                         f"and k={k} (1 to {MAX_POINTS} points, at least 1 centroid, and at "
                         f"least 1 slot, whose buffers fit a block's shared memory)")
    return p


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

    The registered op ``dlbt::ball_query_first_k``: a CPU tensor takes the
    plain version; a CUDA tensor launches the kernel."""
    if pos.device.type not in ("cpu", "cuda"):  # refused by the launch's checks
        _launch(centers, center_mask, pos, mask, radius, k, "kernel")
    return torch.ops.dlbt.ball_query_first_k(centers, center_mask, pos, mask, float(radius), k)


@torch.library.custom_op("dlbt::ball_query_first_k", mutates_args=(), device_types="cuda")
def _ball_query_op(centers: torch.Tensor, center_mask: torch.Tensor, pos: torch.Tensor,
                   mask: torch.Tensor, radius: float, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch(centers, center_mask, pos, mask, radius, k, "kernel")


@_ball_query_op.register_kernel("cpu")
def _(centers, center_mask, pos, mask, radius, k):
    return ball_query_plain(centers, center_mask, pos, mask, radius=radius, k=k)


@_ball_query_op.register_fake
def _(centers, center_mask, pos, mask, radius, k):
    b, m, _ = centers.shape
    return (pos.new_empty((b, m, k), dtype=torch.int32),
            pos.new_empty((b, m, k), dtype=torch.bool))


def probe(centers, center_mask, pos, mask, *, radius: float, k: int = 64, mode: str):
    """The kernel on the card in a measurement ``mode``: "full_scan" (every
    centroid scans every point, with no early exit, and stores the same
    slots), "stage_only" (the staging and the writing of the outputs, no
    scan: every slot 0) or "no_store" (the staging and the scan, the outputs
    left unwritten). No path calls it."""
    return _launch(centers, center_mask, pos, mask, radius, k, mode)


def occupancy(n: int, m: int, k: int) -> dict:
    """``plan(n, m, k)``'s launch on the current card: blocks per SM, threads
    per block, shared memory per block (bytes)."""
    p = launch_plan(n, m, k)
    fn = _build.library().dlbt_ball_query_occupancy
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    per_sm = ctypes.c_int()
    rc = fn(p.warps, p.points, int(p.whole), p.ahead, k, ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"dlbt_ball_query_occupancy failed ({rc})")
    return dict(blocks_per_sm=per_sm.value, threads=32 * p.warps, smem_bytes=smem_bytes(p, k))


def _launch(centers, center_mask, pos, mask, radius, k, mode):
    _check(centers, center_mask, pos, mask, k)
    b, m, _ = centers.shape
    n = pos.shape[1]
    p = launch_plan(n, m, k)
    if pos.device.type != "cuda":
        raise RuntimeError(f"ball_query runs on cuda or cpu tensors, got {pos.device}")
    if center_mask.dtype != torch.bool or mask.dtype != torch.bool:
        raise ValueError("center_mask and mask must be bool")
    centers, center_mask = centers.contiguous(), center_mask.contiguous()
    pos, mask = pos.contiguous(), mask.contiguous()
    _build.check_cuda("ball_query", centers, center_mask, pos, mask)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=pos.device)
    nbr_mask = torch.empty((b, m, k), dtype=torch.bool, device=pos.device)
    _build.launch("dlbt_ball_query", _ARGTYPES, centers.data_ptr(), center_mask.data_ptr(),
                  pos.data_ptr(), mask.data_ptr(), idx.data_ptr(), nbr_mask.data_ptr(),
                  b, m, n, k, _radius2(radius), p.centroids, p.warps, p.points, int(p.whole),
                  p.ahead, MODES[mode], _build.stream_of(pos))
    return idx, nbr_mask
