"""Kernel 1: batched, masked farthest-point sampling from given starts.

``fps_rows`` launches ``csrc/fps.cu`` on a CUDA tensor and runs
``fps_rows_plain`` on a CPU tensor. Both compute the distance in the Pallas
kernel's form, ``|p|^2 - 2 p.l + |l|^2`` (``dl_biomass_tpu/ops/pallas_fps.py``),
in the same operation order, so they agree index for index.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dl_biomass_tpu_torch.ops import _build

# a row stays in shared memory while its 5 float planes fit a block's budget;
# above that (clouds of more than ~10k points per row) it uses global scratch
_SMEM_BYTES = 200 * 1024
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check(pos, mask, starts, k):
    if pos.dim() != 3 or pos.shape[-1] != 3 or pos.dtype != torch.float32:
        raise ValueError(f"pos must be (rows, n, 3) float32, got {tuple(pos.shape)} {pos.dtype}")
    rows, n, _ = pos.shape
    if tuple(mask.shape) != (rows, n) or mask.dtype != torch.bool:
        raise ValueError("mask must be (rows, n) bool")
    if tuple(starts.shape) != (rows,):
        raise ValueError("starts must be (rows,)")
    if not 0 < k <= n:
        raise ValueError(f"k={k} out of range for n={n}")


def fps_rows_plain(pos: torch.Tensor, mask: torch.Tensor, starts: torch.Tensor,
                   k: int) -> torch.Tensor:
    """The plain PyTorch version: the same k dependent argmax steps, one
    vectorised pass over all rows per step."""
    _check(pos, mask, starts, k)
    rows, n, _ = pos.shape
    px, py, pz = pos.unbind(-1)
    sq = px * px + py * py + pz * pz
    neg = torch.tensor(-math.inf, device=pos.device)
    dist = torch.where(mask, torch.tensor(math.inf, device=pos.device), neg)
    lane = torch.arange(n, device=pos.device)
    prev = starts.long()
    out = torch.empty((rows, k), dtype=torch.int32, device=pos.device)
    out[:, 0] = prev
    for s in range(1, k):
        last = pos.gather(1, prev[:, None, None].expand(-1, 1, 3))[:, 0]  # (rows, 3)
        lx, ly, lz = last[:, 0:1], last[:, 1:2], last[:, 2:3]
        t = px * lx + py * ly + pz * lz
        ll = lx * lx + ly * ly + lz * lz
        d = sq - 2.0 * t + ll
        # fmin, like the kernel's fminf: a NaN distance (garbage coordinates
        # in a pad row) never displaces the row's -inf
        dist = torch.where(lane == prev[:, None], neg, torch.fmin(dist, d))
        prev = dist.argmax(dim=1)  # first index among equal maxima
        out[:, s] = prev
    return out


def fps_rows(pos: torch.Tensor, mask: torch.Tensor, starts: torch.Tensor,
             k: int) -> torch.Tensor:
    """pos (rows, n, 3) f32, mask (rows, n) bool, starts (rows,) -> (rows, k) int32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if pos.device.type == "cpu":
        return fps_rows_plain(pos, mask, starts, k)
    if pos.device.type != "cuda":
        raise RuntimeError(f"fps_rows runs on cuda or cpu tensors, got {pos.device}")
    _check(pos, mask, starts, k)
    rows, n, _ = pos.shape
    starts = starts.to(torch.int32).contiguous()
    _build.check_cuda("fps_rows", pos, mask, starts)
    out = torch.empty((rows, k), dtype=torch.int32, device=pos.device)
    scratch = None
    if 5 * n * 4 > _SMEM_BYTES:
        scratch = torch.empty((rows, 5, n), dtype=torch.float32, device=pos.device)
    _build.launch("dlbt_fps", _ARGTYPES, pos.data_ptr(), mask.data_ptr(), starts.data_ptr(),
                  out.data_ptr(), _build.ptr(scratch), rows, n, k, _build.stream_of(pos))
    return out

