"""Phase bisection of the rank-scatter ball query at SA2 scale (port of the
JAX package's ``tools/bq_phase_bench.py``), with kernel 9
(``csrc/bq_phase.cu``) in place of the TPU tool's Pallas kernel.

For a valid centroid, the in-radius points are the valid points with
``dx*dx + dy*dy + dz*dz <= r2`` (each operation rounded on its own; r2 is
``float(radius) ** 2`` rounded once to float32, as the TPU tool compares),
taken in index order; a point's rank is its place in that list and its
residue bucket is ``index % 128``. The variants (``phase``):

- ``full``, ``mstatic``, ``munroll``, ``when``: slot ``rank < k`` holds the
  point's index if it is among the first 8 in-radius points of its bucket,
  else ``n``. Dropped points leave holes: the slots are not compacted. The
  slots past the last in-radius point hold ``n``. The four differ only in how
  the TPU loops, so they launch the same instantiation of kernel 9;
- ``dyn``: the same with no cap, the exact first ``k``;
- ``when<N>`` (``when4``, ``when12``, ``when0``, ...): the cap is N;
- the stubs, each value repeated over the ``k`` slots: ``dist`` the
  in-radius count; ``rank`` and ``extract`` the smallest packed key
  ``(min(rank, k) << 24) | index``, which is the first in-radius index, or
  ``2**31 - 1`` where there is none.

An invalid centroid gives ``n`` in every slot (``dist`` 0, ``rank`` and
``extract`` ``2**31 - 1``). ``cm`` is the TPU tool's centroids per block
(1-32): checked, it changes no result, and the launch no longer reads it.

``plan(n, m, k)`` names kernel 9's launch, the design of kernel 3
(``ops/ball_query_kernel.py``): the centroids a block, its warps, the points
staged in shared memory at once, and whether the cloud is staged whole (the
warps then take the block's centroids from a shared counter; ``dist`` two at
a time, each point tested against both) or a chunk at a time (one centroid a
warp). ``probe`` (no early exit, the staging alone, no writing)
and ``launch_of`` measure the kernel; no path calls them.

``main`` times ``full``, ``mstatic`` and ``munroll`` at ``cm=32`` on the JAX
tool's data, each as a chain of ``LOOPS`` dependent calls (the centroids
nudged by a zero taken from the previous output), best of ``WINDOWS``:

    python -m dl_biomass_tpu_torch.tools.bq_phase_bench [B] [M] [N]
"""

from __future__ import annotations

import ctypes
import re
import sys
from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device, round_up
from dl_biomass_tpu_torch.ops import _build
from dl_biomass_tpu_torch.ops.grouping import in_radius
from dl_biomass_tpu_torch.tools._timing import best_chain_s

LOOPS = 20  # dependent calls per timed chain
WINDOWS = 3  # timed chains, best taken
TIMED_PHASES = ("full", "mstatic", "munroll")
RADIUS = 8.0
PHASES = ("dist", "rank", "extract", "full", "dyn", "mstatic", "munroll", "when", "when4",
          "when12", "when0")  # the variants the tests and chip_smoke.py hold
CHUNK = 256  # centroids per block of the plain version

_G = 128  # residue buckets
_R = 8  # the TPU kernel's extraction rounds: the bucket cap of full and extract
_KEY_BITS = 24
INT_BIG = 0x7FFFFFFF
# kernel 9's modes, as csrc/bq_phase.cu numbers them
DIST, RANK, EXTRACT, WRITE = range(4)
# the kernel on every path, and the measurements: no early exit, the staging
# of the cloud alone (the outputs as for no hit), the scan without the writing
MODES = {"kernel": 0, "full_scan": 1, "loads_only": 2, "no_store": 3}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])

# The launch (csrc/bq_phase.cu), as kernel 3's: a warp tests GROUP points (8
# chunks of 32) before it reads its hit count, and the cloud is padded to a
# multiple of GROUP; where the padded cloud fits a block (whole), the warps
# and centroids a block where two blocks fit an SM's shared memory (SHARED: 8
# warps, so that four blocks fit its registers), and where one fills it
# (ALONE); larger clouds are staged CHUNK_POINTS at a time, one centroid a warp
GROUP = 256
SHARED_WARPS, SHARED_CENTROIDS = 8, 32
ALONE_WARPS, ALONE_CENTROIDS = 32, 128
CHUNK_WARPS, CHUNK_POINTS = 32, 8192
POINT_BYTES = 16  # one float4 a staged point, or a staged centroid of a whole tile
SLOT_BYTES = 4  # a warp's slots: k int32 in shared memory
STATIC_SMEM = 16  # the whole kernel's centroid counter, rounded up
SMEM_PER_BLOCK = 232448  # the shared memory a block may have on an H100 (227 KB)
MAX_POINTS = (1 << 24) - 1  # the packed key's 24 index bits


class Plan(NamedTuple):
    centroids: int  # centroids a block (one a warp where chunked)
    warps: int  # warps a block
    points: int  # points staged in shared memory at once
    whole: bool  # the cloud staged whole (else a chunk of `points` at a time)


def smem_bytes(p: Plan, k: int) -> int:
    """A block's shared memory: its staged points (and centroids, whole),
    each warp's k slots, and the whole kernel's counter."""
    return dynamic_smem(p, k) + (STATIC_SMEM if p.whole else 0)


def dynamic_smem(p: Plan, k: int) -> int:
    """The part of it the launch asks for: the staged points and centroids
    and the slots."""
    staged = p.points + (p.centroids if p.whole else 0)
    return staged * POINT_BYTES + p.warps * k * SLOT_BYTES


def plan(n: int, m: int, k: int) -> Optional[Plan]:
    """The launch for clouds of ``n`` points (0 to 2**24 - 1), ``m``
    centroids (at least 1) and ``k`` slots (1-127), or None where the kernel
    takes no such clouds."""
    if not (0 <= n <= MAX_POINTS and m >= 1 and 1 <= k <= 127):
        return None
    n_pad = round_up(n, GROUP)
    shared = Plan(SHARED_CENTROIDS, SHARED_WARPS, n_pad, True)
    if 2 * smem_bytes(shared, k) <= SMEM_PER_BLOCK:  # blocks share an SM
        return shared
    alone = Plan(ALONE_CENTROIDS, ALONE_WARPS, n_pad, True)
    if smem_bytes(alone, k) <= SMEM_PER_BLOCK:  # one block fills an SM
        return alone
    return Plan(CHUNK_WARPS, CHUNK_WARPS, CHUNK_POINTS, False)


def launch_plan(n: int, m: int, k: int) -> Plan:
    """``plan(n, m, k)``, or ValueError where the kernel takes no such clouds."""
    p = plan(n, m, k)
    if p is None:
        raise ValueError(f"bq: the kernel takes no clouds of {n} points, {m} centroids and "
                         f"k={k} (0 to {MAX_POINTS} points, at least 1 centroid, 1-127 slots)")
    return p


def variant(phase: str) -> Tuple[int, Optional[int]]:
    """(mode, bucket cap) of a phase string; the cap is None for ``dyn``."""
    if phase in ("dist", "rank"):
        return (DIST if phase == "dist" else RANK), None
    if phase == "extract":
        return EXTRACT, _R
    if phase in ("full", "mstatic", "munroll", "when"):
        return WRITE, _R
    if phase == "dyn":
        return WRITE, None
    found = re.fullmatch(r"when(\d+)", phase)
    if found:
        return WRITE, int(found.group(1))
    raise ValueError(f"unknown phase {phase!r}")


def radius2(radius: float) -> float:
    """The TPU tool's ``float(radius) ** 2``, rounded once to float32."""
    return float(np.float32(float(radius) ** 2))


def _check(centers, center_mask, pos, mask, k: int, cm: int, phase: str):
    b, m, _ = centers.shape
    n = pos.shape[1]
    if centers.dtype != torch.float32 or pos.dtype != torch.float32:
        raise ValueError("centers and pos must be float32")
    if tuple(center_mask.shape) != (b, m) or tuple(mask.shape) != (b, n):
        raise ValueError("center_mask must be (B, M) and mask (B, N)")
    # the packed key (rank << 24) | index must stay a positive int32
    if not 1 <= k <= 127:
        raise ValueError(f"k={k} must be 1-127: the packed key holds the rank in 7 bits")
    if n >= 1 << _KEY_BITS:
        raise ValueError(f"n={n} must be below 2**24: the packed key holds the index in 24 bits")
    if not 1 <= cm <= 32:
        raise ValueError(f"cm={cm} must be 1-32 centroids per block")
    return variant(phase)


def bq_plain(centers: torch.Tensor, center_mask: torch.Tensor, pos: torch.Tensor,
             mask: torch.Tensor, *, radius: float, k: int = 64, cm: int = 32,
             phase: str = "full") -> torch.Tensor:
    """The plain PyTorch version, chunked over centroids: exclusive cumsums give
    each in-radius point its rank and the count of in-radius points before it
    in its bucket; the kept points scatter their indices to their ranks."""
    mode, cap = _check(centers, center_mask, pos, mask, k, cm, phase)
    b, m, _ = centers.shape
    n = pos.shape[1]
    dev = pos.device
    r2 = radius2(radius)
    n_pad = round_up(max(n, 1), _G)
    index = torch.arange(n_pad, device=dev)
    out = torch.empty((b, m, k), dtype=torch.int32, device=dev)
    for s in range(0, m, CHUNK):
        ok = in_radius(centers[:, s:s + CHUNK], center_mask[:, s:s + CHUNK], pos, mask, r2)
        mc = ok.shape[1]
        ok = torch.cat([ok, ok.new_zeros((b, mc, n_pad - n))], dim=2)  # padding: never in radius
        hits = ok.to(torch.int32)
        if mode == DIST:
            out[:, s:s + mc] = hits.sum(2, dtype=torch.int32)[..., None]
            continue
        rank = torch.cumsum(hits, 2) - hits
        packed = (rank.clamp(max=k) << _KEY_BITS) | index
        if mode == RANK:
            out[:, s:s + mc] = torch.where(ok, packed, INT_BIG).amin(2)[..., None]
            continue
        keep = ok
        if cap is not None:
            by_bucket = hits.view(b, mc, n_pad // _G, _G)
            before = (torch.cumsum(by_bucket, 2) - by_bucket).view(b, mc, n_pad)
            keep = ok & (before < cap)
        if mode == EXTRACT:
            out[:, s:s + mc] = torch.where(keep, packed, INT_BIG).amin(2)[..., None]
            continue
        slot = torch.where(keep & (rank < k), rank, k)  # slot k: dropped, cut off below
        rows = torch.full((b, mc, k + 1), n, dtype=torch.int64, device=dev)
        rows.scatter_(2, slot, index.expand(b, mc, n_pad))
        out[:, s:s + mc] = rows[:, :, :k]
    return out


def bq(centers: torch.Tensor, center_mask: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor,
       *, radius: float, k: int = 64, cm: int = 32, phase: str = "full") -> torch.Tensor:
    """centers (B, M, 3) f32, center_mask (B, M) bool, pos (B, N, 3) f32,
    mask (B, N) bool -> (B, M, K) int32, the variant ``phase`` of the module
    docstring.

    A CPU tensor takes the plain version; a CUDA tensor launches kernel 9
    (``dlbt_bq_phase``) once, as ``plan`` names it, on the points as they
    are (no copy)."""
    if pos.device.type == "cpu":
        return bq_plain(centers, center_mask, pos, mask, radius=radius, k=k, cm=cm, phase=phase)
    return _launch(centers, center_mask, pos, mask, radius, k, cm, phase, "kernel")


def probe(centers, center_mask, pos, mask, *, radius: float, k: int = 64, cm: int = 32,
          phase: str = "full", mode: str) -> torch.Tensor:
    """Kernel 9 on the card in a measurement ``mode``: "full_scan" (no early
    exit; the same output), "loads_only" (the cloud staged, no test: the
    output of a centroid with no hit) or "no_store" (the scan, the output
    left unwritten). No path calls it."""
    return _launch(centers, center_mask, pos, mask, radius, k, cm, phase, mode)


def launch_of(b: int, n: int, m: int, k: int, phase: str = "full") -> dict:
    """The launch ``bq`` makes for B clouds of ``n`` points, ``m`` centroids
    and ``k`` slots on the current card, as the kernel's source computes it
    from ``plan(n, m, k)``: blocks per SM, threads and dynamic shared memory
    (bytes) a block, the grid, registers and local memory (bytes: spills) a
    thread."""
    p = launch_plan(n, m, k)
    fn = _build.library().dlbt_bq_phase_launch
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 7)()
    rc = fn(variant(phase)[0], b, m, n, k, p.centroids, p.warps, p.points, int(p.whole), vals)
    if rc != 0:
        raise RuntimeError(f"dlbt_bq_phase_launch failed ({rc})")
    return dict(blocks_per_sm=vals[0], threads=vals[1], smem_bytes=vals[2],
                grid=(vals[3], vals[4]), registers=vals[5], local_bytes=vals[6])


def _launch(centers, center_mask, pos, mask, radius, k, cm, phase, probe_mode):
    if pos.device.type != "cuda":
        raise RuntimeError(f"bq runs on cuda or cpu tensors, got {pos.device}")
    mode, cap = _check(centers, center_mask, pos, mask, k, cm, phase)
    b, m, _ = centers.shape
    n = pos.shape[1]
    centers, pos = centers.contiguous(), pos.contiguous()
    center_mask = center_mask.to(torch.bool).contiguous()
    mask = mask.to(torch.bool).contiguous()
    _build.check_cuda("bq", centers, center_mask, pos, mask)
    out = torch.empty((b, m, k), dtype=torch.int32, device=pos.device)
    if out.numel() == 0:
        return out
    p = launch_plan(n, m, k)
    # a bucket's count before a written point is at most its rank (< k): a cap
    # of k or more caps nothing, and the kernel's counters stay below 128
    eff_cap = k if cap is None else min(cap, k)
    _build.launch("dlbt_bq_phase", _ARGTYPES, centers.data_ptr(), center_mask.data_ptr(),
                  pos.data_ptr(), mask.data_ptr(), out.data_ptr(), b, m, n, k, mode, eff_cap,
                  radius2(radius), p.centroids, p.warps, p.points, int(p.whole),
                  MODES[probe_mode], _build.stream_of(pos))
    return out


def tool_data(b: int, m: int, n: int, device):
    """The JAX tool's input: numpy seed 0, ``normal * 5``, every point valid,
    the first ``m`` points as centroids."""
    rng = np.random.default_rng(0)
    pos = torch.from_numpy((rng.normal(size=(b, n, 3)) * 5).astype(np.float32)).to(device)
    mask = torch.ones((b, n), dtype=torch.bool, device=device)
    return pos[:, :m], mask[:, :m], pos, mask


def timed_ms(fn, centers, cmask, pos, mask) -> float:
    """ms per call of ``fn`` in a chain of dependent calls: each call's
    centroids are the last ones plus a zero taken from its output."""
    c = centers

    def step():
        nonlocal c
        out = fn(c, cmask, pos, mask)
        c = c + (out[0, 0].sum() & 0).to(c.dtype)

    return best_chain_s(step, pos.device, LOOPS, WINDOWS) * 1e3


def main(b: int = 36, m: int = 512, n: int = 2048, device=None) -> list:
    """Time each phase of ``TIMED_PHASES`` at ``cm=32``; prints a line each
    and returns them as dicts."""
    dev = resolve_device(device)
    centers, cmask, pos, mask = tool_data(b, m, n, dev)
    rows = []
    for phase in TIMED_PHASES:
        for cm in (32,):
            fn = partial(bq, radius=RADIUS, cm=cm, phase=phase)
            ms = timed_ms(fn, centers, cmask, pos, mask)
            print(f"phase={phase:8s} cm={cm:3d}: {ms:7.3f} ms", flush=True)
            rows.append(dict(phase=phase, cm=cm, ms=ms))
    return rows


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])
