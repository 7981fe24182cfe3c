"""Kernel 1: batched, masked farthest-point sampling from given starts.

``fps_rows`` launches ``csrc/fps.cu`` on a CUDA tensor and runs
``fps_rows_plain`` on a CPU tensor. Both compute the distance in the Pallas
kernel's form, ``|p|^2 - 2 p.l + |l|^2`` (``dl_biomass_tpu/ops/pallas_fps.py``),
in the same operation order, so they agree index for index.

``plan(n)`` chooses the launch for rows of n points, mirroring the kernel's
template dispatch: a row of at most ``32 * P_MAX`` points is one warp,
``ROWS_PER_WARP_BLOCK`` rows a block; a longer one the fewest warps that hold
it at ``P_MAX`` points a thread in a block of at most 256 threads (255
registers a thread), else at ``WIDE_P_MAX`` in one of up to 512 (128
registers) or 1024 (64), one row a block; each thread keeps its points in
registers. A row beyond that keeps its points and running minima in a
global scratch buffer. ``chain_only`` and ``occupancy`` measure the kernel;
no path calls them.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from dl_biomass_tpu_torch.ops import _build

# the register kernel's instantiations (fps.cu): points a thread, by the most
# threads its block may have; __launch_bounds__(MAXT, 1) gives a thread of a
# block of at most 256 threads 255 registers, 512 threads 128, 1024 threads 64
POINTS_PER_THREAD = {256: (2, 4, 6, 8, 10, 12), 512: (10,), 1024: (10,)}
REGISTERS_PER_THREAD = {256: 255, 512: 128, 1024: 64}
P_MAX = 12
WIDE_P_MAX = 10
MAX_WARPS = 32
ROWS_PER_WARP_BLOCK = 4
PLANES_WARPS = 32
# five registers hold each point (x, y, z, |p|^2, running min), the rest the loop
REGISTERS_PER_POINT = 5
LOOP_REGISTERS = 14
# the kernel addresses a row's coordinates (3 n floats) with 32-bit ints
MAX_POINTS = (2**31 - 1) // 3
_PATH_CODE = {"warp": 0, "block": 0, "planes": 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


class Plan(NamedTuple):
    warps_per_row: int
    points_per_thread: int
    rows_per_block: int
    path: str  # "warp", "block" (registers) or "planes" (global scratch)


def block_limit(threads: int) -> int:
    """The most threads a block of ``threads`` is compiled for: 256, 512 or 1024."""
    return next(limit for limit in (256, 512, 1024) if threads <= limit)


def _fewest_points(n: int, threads: int) -> int:
    need = -(-n // threads)
    return next(p for p in POINTS_PER_THREAD[block_limit(threads)] if p >= need)


def plan(n: int) -> Optional[Plan]:
    """The launch for rows of ``n`` points, or None where no path takes them."""
    if not 1 <= n <= MAX_POINTS:
        return None
    if n <= 32 * P_MAX:
        return Plan(1, _fewest_points(n, 32), ROWS_PER_WARP_BLOCK, "warp")
    warps = -(-n // (32 * P_MAX))
    if 32 * warps > 256:
        warps = -(-n // (32 * WIDE_P_MAX))
    if warps <= MAX_WARPS:
        return Plan(warps, _fewest_points(n, 32 * warps), 1, "block")
    return Plan(PLANES_WARPS, -(-n // (32 * PLANES_WARPS)), 1, "planes")


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

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    on ``plan(n)``'s path, and a row length no path takes raises."""
    if pos.device.type == "cpu":
        return fps_rows_plain(pos, mask, starts, k)
    return _launch("dlbt_fps", pos, mask, starts, k)


def chain_only(pos, mask, starts, k) -> torch.Tensor:
    """The kernel's k-step loop on ``plan(n)``'s path with the per-point work
    removed, on the card: the reduction, the barrier and the winner's read
    alone. A measurement of what the dependent chain costs; its picks mean
    nothing."""
    return _launch("dlbt_fps_chain", pos, mask, starts, k)


def launch_plan(n: int) -> Plan:
    """``plan(n)``, or ValueError where no path takes rows of n points."""
    p = plan(n)
    if p is None:
        raise ValueError(f"fps_rows: no kernel path takes rows of {n} points "
                         f"(1 to {MAX_POINTS})")
    return p


def occupancy(n: int) -> dict:
    """``plan(n)``'s launch on the current card: blocks per SM, threads per
    block, shared memory per block (bytes)."""
    p = launch_plan(n)
    fn = _build.library().dlbt_fps_occupancy
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    per_sm, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = fn(n, _PATH_CODE[p.path], p.warps_per_row, p.points_per_thread, p.rows_per_block,
            ctypes.byref(per_sm), ctypes.byref(threads), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"dlbt_fps_occupancy failed ({rc})")
    return dict(blocks_per_sm=per_sm.value, threads=threads.value, smem_bytes=smem.value)


def _launch(entry, pos, mask, starts, k):
    _check(pos, mask, starts, k)
    rows, n, _ = pos.shape
    p = launch_plan(n)
    if pos.device.type != "cuda":
        raise RuntimeError(f"fps_rows runs on cuda or cpu tensors, got {pos.device}")
    starts = starts.to(torch.int32).contiguous()
    _build.check_cuda("fps_rows", pos, mask, starts)
    out = torch.empty((rows, k), dtype=torch.int32, device=pos.device)
    scratch = None
    if p.path == "planes":
        scratch = torch.empty(5 * rows * n, dtype=torch.float32, device=pos.device)
    _build.launch(entry, _ARGTYPES, pos.data_ptr(), mask.data_ptr(), starts.data_ptr(),
                  out.data_ptr(), _build.ptr(scratch), rows, n, k, _PATH_CODE[p.path],
                  p.warps_per_row, p.points_per_thread, p.rows_per_block,
                  _build.stream_of(pos))
    return out
