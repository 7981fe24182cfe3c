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
``extract`` ``2**31 - 1``). ``cm`` is the number of centroids, one warp each,
per CUDA block (1-32); it changes no result.

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
from typing import Optional, Tuple

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
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])


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
    (``dlbt_bq_phase``)."""
    if pos.device.type == "cpu":
        return bq_plain(centers, center_mask, pos, mask, radius=radius, k=k, cm=cm, phase=phase)
    if pos.device.type != "cuda":
        raise RuntimeError(f"bq runs on cuda or cpu tensors, got {pos.device}")
    mode, cap = _check(centers, center_mask, pos, mask, k, cm, phase)
    b, m, _ = centers.shape
    n = pos.shape[1]
    planes = pos.transpose(1, 2).contiguous()  # (B, 3, N)
    centers = centers.contiguous()
    center_mask = center_mask.to(torch.bool).contiguous()
    mask = mask.to(torch.bool).contiguous()
    _build.check_cuda("bq", centers, center_mask, planes, mask)
    out = torch.empty((b, m, k), dtype=torch.int32, device=pos.device)
    if out.numel() == 0:
        return out
    # a bucket's count before a written point is at most its rank (< k): a cap
    # of k or more caps nothing, and the kernel's counters stay below 128
    eff_cap = k if cap is None else min(cap, k)
    _build.launch("dlbt_bq_phase", _ARGTYPES, centers.data_ptr(), center_mask.data_ptr(),
                  planes.data_ptr(), mask.data_ptr(), out.data_ptr(), b, m, n, k, cm, mode,
                  eff_cap, radius2(radius), _build.stream_of(pos))
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
