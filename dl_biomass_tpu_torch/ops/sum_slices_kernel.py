"""The cross-block step of kernels 7-B, 8 and 11 (``csrc/sum_slices.cu``):
the float32 slices that a kernel's blocks write, added in float64 in a fixed
order and rounded once to float32 (or kept in float64: kernel 11's chunk
partials), so the sum repeats bit for bit without float atomics.
``sum_slices`` launches ``dlbt_sum_slices`` (``_f64``) on a CUDA tensor and
runs ``sum_slices_plain`` on a CPU tensor.

The order, which ``plan(blocks, n)`` names: the slices are split into
``groups`` runs of consecutive slices (the first ``blocks % groups`` runs one
slice longer, ``runs`` gives them); each run's slices are added in slice
order, the runs' sums ``SPAN`` at a time in run order, then those spans' sums
in span order, each sum from 0.0. ``empty`` measures the floor a launch sets;
no path calls it."""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from dl_biomass_tpu_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MAX_THREADS = 256  # threads a block (csrc/sum_slices.cu kMaxThreads)
MIN_COLS, MAX_COLS = 8, 256  # values a block
# the narrowest tile at or above MIN_COLS that still gives this many blocks:
# about one an SM of an H100's 132, where a thread loads 16 slices at once
# (within 0.0003 ms of the fastest tile at each of the four shapes of
# chip_compare.py sumtune on an H100)
TARGET_BLOCKS = 128
SUM_BYTES = 8  # a run's partial sum of one value in shared memory (f64)
SPAN = 8  # runs' sums a thread adds before one thread a value adds the spans


class Plan(NamedTuple):
    vec: int  # values a thread loads at once: 4 (16 bytes) where n % 4 == 0, else 1
    cols: int  # values a block
    groups: int  # runs of consecutive slices, one row of threads each
    threads: int  # threads a block: groups * cols / vec
    grid: int  # blocks: n / cols, rounded up
    smem_bytes: int  # the runs' partial sums, groups * cols f64


def plan(blocks: int, n: int) -> Optional[Plan]:
    """The launch that sums ``blocks`` slices of ``n`` values, or None for
    negative sizes. Narrow n takes narrow tiles and many runs, so that it
    spreads over many SMs; wide n tiles of up to 256 values, coalesced rows."""
    if blocks < 0 or n < 0:
        return None
    vec = 4 if n % 4 == 0 else 1
    cols = MAX_COLS
    while cols > MIN_COLS and -(-n // cols) < TARGET_BLOCKS:
        cols //= 2
    groups = max(1, min(MAX_THREADS * vec // cols, blocks))
    return Plan(vec, cols, groups, groups * cols // vec, -(-n // cols),
                groups * cols * SUM_BYTES)


def runs(blocks: int, groups: int) -> List[Tuple[int, int]]:
    """The slices of each run, [lo, hi), in run order: ``blocks`` split into
    ``groups`` runs of consecutive slices, the first ``blocks % groups`` one
    slice longer."""
    per, extra = divmod(blocks, groups)
    out, lo = [], 0
    for g in range(groups):
        hi = lo + per + (1 if g < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def sum_slices_plain(slices: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version: the slices added in float64, returned in ``dtype``."""
    return slices.double().sum(0).to(dtype)


def sum_slices(slices: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(blocks, n) float32 -> (n,) ``dtype``, the slices added in float64 in
    the order of the module docstring and rounded once to float32, or kept
    in float64 (``dtype=torch.float64``: ``dlbt_sum_slices_f64``)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sum_slices returns float32 or float64, not {dtype}")
    if slices.device.type == "cpu":
        return sum_slices_plain(slices, dtype)
    if slices.device.type != "cuda":
        raise RuntimeError(f"sum_slices runs on cuda or cpu tensors, got {slices.device}")
    if slices.dim() != 2 or slices.dtype != torch.float32:
        raise ValueError(f"slices must be (blocks, n) float32, got {tuple(slices.shape)} "
                         f"{slices.dtype}")
    p = plan(*slices.shape)
    slices = _build.aligned16(slices.contiguous()) if p.vec == 4 else slices.contiguous()
    _build.check_cuda("sum_slices", slices)
    out = torch.empty(slices.shape[1], dtype=dtype, device=slices.device)
    if p.grid == 0:
        return out
    entry = "dlbt_sum_slices" if dtype == torch.float32 else "dlbt_sum_slices_f64"
    _build.launch(entry, _ARGTYPES, slices.data_ptr(), out.data_ptr(), slices.shape[0],
                  slices.shape[1], p.vec, p.cols, p.groups, _build.stream_of(slices))
    return out


def empty(slices: torch.Tensor) -> None:
    """An empty kernel on the CUDA grid and block that ``sum_slices`` launches
    for these slices (``dlbt_sum_slices_empty``): the floor a launch sets."""
    p = plan(*slices.shape)
    _build.launch("dlbt_sum_slices_empty", [ctypes.c_int] * 5 + [ctypes.c_void_p],
                  slices.shape[0], slices.shape[1], p.vec, p.cols, p.groups,
                  _build.stream_of(slices))
