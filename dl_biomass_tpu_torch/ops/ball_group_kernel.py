"""Kernel 2: stratified ball query fused with the capture of the edge features.

Selection rule (``dl_biomass_tpu/ops/pallas_group.py`` stratified_pair_select):
points fall into 128 residue buckets (index mod 128), and output slot j of 64
holds the smallest in-radius valid index whose residue is j or j + 64. The
captured edge row is ``[feat_j, pos_j - center_i]`` in the output type, zero
where the slot is invalid — the SA1 MLP input, with no gather outside.

``ball_group`` calls the registered op ``torch.ops.dlbt.ball_group``, which
launches ``csrc/ball_group.cu`` on a CUDA tensor and runs
``ball_group_plain`` on a CPU tensor (its fake implementation gives shapes
from shapes, for ``torch.export``).

``plan(n, m)`` names the launch for clouds of n points and m centroids,
mirroring the kernel's template dispatch: the centroids a 128-thread block
tests each point against, and the points a thread takes a chunk. ``probe``
and ``occupancy`` measure the kernel; no path calls them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dl_biomass_tpu_torch.core.cloud import round_up
from dl_biomass_tpu_torch.ops import _build
from dl_biomass_tpu_torch.ops.grouping import in_radius

G = 128  # residue buckets
K = 64  # output slots
CHUNK = 128  # centroids per block of the plain version: (B, 128, N) fits at full size
MAX_F = 4  # features the kernel captures
# the kernel's instantiations (csrc/ball_group.cu): centroids a block, points a
# thread a chunk
CENTROIDS = (4, 8, 16)
CHUNK_POINTS = (4, 8, 16)
# a thread of a 128-thread block compiled for four blocks an SM has 128
# registers: 5 a centroid (x, y, z, its first hit, the chunk's), 4 for the point
# under test, and the loop's own; the points of a chunk loaded ahead take what
# is left (ptxas, chip_compare.py group: 126 at 16 centroids and 8 points, no spill)
REGISTERS_PER_THREAD = 128
REGISTERS_PER_CENTROID, REGISTERS_PER_POINT, LOOP_REGISTERS = 5, 4, 24
SMEM_PER_BLOCK = 48 * 1024  # static shared memory a block may have
THREADS = G  # one thread a bucket
# the plan, the fastest of the instantiations at every shape of the paths
# (chip_compare.py grouptune): 16 centroids a block, 8 points a thread a chunk
PLAN_CENTROIDS, PLAN_POINTS = 16, 8
MAX_POINTS = (2**31 - 1) // 4  # the kernel indexes points with 32-bit ints
MODES = {"kernel": 0, "scan_only": 1, "full_scan": 2}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


class Plan(NamedTuple):
    centroids: int  # centroids a block (kC)
    points: int  # points a thread a chunk (kT)


def plan(n: int, m: int) -> Optional[Plan]:
    """The launch for clouds of ``n`` points and ``m`` centroids, or None
    where the kernel takes no such clouds."""
    if not (1 <= n <= MAX_POINTS and m >= 1):
        return None
    return Plan(PLAN_CENTROIDS, PLAN_POINTS)


def launch_plan(n: int, m: int) -> Plan:
    """``plan(n, m)``, or ValueError where the kernel takes no such clouds."""
    p = plan(n, m)
    if p is None:
        raise ValueError(f"ball_group: the kernel takes no clouds of {n} points and {m} "
                         f"centroids (1 to {MAX_POINTS} points, at least 1 centroid)")
    return p


def smem_bytes(p: Plan) -> int:
    """A block's shared memory: the bucket minima of its centroids."""
    return p.centroids * G * 4


def registers(p: Plan) -> int:
    """The registers a thread of the plan's scan needs at the least, by the
    count above."""
    return p.centroids * REGISTERS_PER_CENTROID + REGISTERS_PER_POINT + LOOP_REGISTERS


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
    if center_mask.dtype != torch.bool or mask.dtype != torch.bool:
        raise ValueError("center_mask and mask must be bool")
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

    The registered op ``dlbt::ball_group``: a CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if pos.device.type not in ("cpu", "cuda"):  # refused by the launch's checks
        _launch(centers, center_mask, pos, mask, feat, radius, out_dtype, need_idx, "kernel")
    idx, nbr_mask, edges = torch.ops.dlbt.ball_group(centers, center_mask, pos, mask, feat,
                                                     float(radius), out_dtype, need_idx)
    return (idx if need_idx else None), nbr_mask, edges


def _no_idx(idx, like):
    # an op returns tensors only: "no index" is an empty one
    return idx if idx is not None else like.new_empty((0,), dtype=torch.int32)


@torch.library.custom_op("dlbt::ball_group", mutates_args=(), device_types="cuda")
def _ball_group_op(centers: torch.Tensor, center_mask: torch.Tensor, pos: torch.Tensor,
                   mask: torch.Tensor, feat: Optional[torch.Tensor], radius: float,
                   out_dtype: torch.dtype, need_idx: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    idx, nbr_mask, edges = _launch(centers, center_mask, pos, mask, feat, radius, out_dtype,
                                   need_idx, "kernel")
    return _no_idx(idx, pos), nbr_mask, edges


@_ball_group_op.register_kernel("cpu")
def _(centers, center_mask, pos, mask, feat, radius, out_dtype, need_idx):
    idx, nbr_mask, edges = ball_group_plain(centers, center_mask, pos, mask, feat,
                                            radius=radius, out_dtype=out_dtype,
                                            need_idx=need_idx)
    return _no_idx(idx, pos), nbr_mask, edges


@_ball_group_op.register_fake
def _(centers, center_mask, pos, mask, feat, radius, out_dtype, need_idx):
    b, m, _ = centers.shape
    f = 0 if feat is None else feat.shape[-1]
    idx = pos.new_empty((b, m, K) if need_idx else (0,), dtype=torch.int32)
    return (idx, pos.new_empty((b, m, K), dtype=torch.bool),
            pos.new_empty((b, m, K, f + 3), dtype=out_dtype))


def probe(centers, center_mask, pos, mask, feat=None, *, radius: float, mode: str,
          out_dtype=torch.float32):
    """The kernel's scan alone, on the card: ``mode`` "scan_only" (the
    selection without the capture and stores) or "full_scan" (the same with
    no early exit). A measurement; its outputs mean nothing and no path
    calls it."""
    return _launch(centers, center_mask, pos, mask, feat, radius, out_dtype, False, mode)


def occupancy(n: int, m: int) -> dict:
    """``plan(n, m)``'s launch on the current card: blocks per SM, threads per
    block, shared memory per block (bytes)."""
    p = launch_plan(n, m)
    fn = _build.library().dlbt_ball_group_occupancy
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    per_sm = ctypes.c_int()
    rc = fn(p.centroids, p.points, ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"dlbt_ball_group_occupancy failed ({rc})")
    return dict(blocks_per_sm=per_sm.value, threads=THREADS, smem_bytes=smem_bytes(p))


def _launch(centers, center_mask, pos, mask, feat, radius, out_dtype, need_idx, mode):
    _check(centers, center_mask, pos, mask, feat)
    b, m, _ = centers.shape
    n = pos.shape[1]
    f = 0 if feat is None else feat.shape[-1]
    if f > MAX_F:
        raise ValueError(f"ball_group: the kernel captures at most {MAX_F} features, got {f}")
    p = launch_plan(n, m)
    if pos.device.type != "cuda":
        raise RuntimeError(f"ball_group runs on cuda or cpu tensors, got {pos.device}")
    # one float4 a point, (x, y, z, 0), NaN where masked: a masked point fails every test
    pts = torch.where(mask[..., None], F.pad(pos, (0, 1)), float("nan"))
    centers, center_mask = centers.contiguous(), center_mask.contiguous()
    feat = None if f == 0 else feat.contiguous()
    _build.check_cuda("ball_group", *(t for t in (centers, center_mask, pts, feat)
                                      if t is not None))
    dev = pos.device
    edges = torch.empty((b, m, K, f + 3), dtype=out_dtype, device=dev)
    nbr_mask = torch.empty((b, m, K), dtype=torch.bool, device=dev)
    idx = torch.empty((b, m, K), dtype=torch.int32, device=dev) if need_idx else None
    _build.launch("dlbt_ball_group", _ARGTYPES, centers.data_ptr(), center_mask.data_ptr(),
                  pts.data_ptr(), _build.ptr(feat), edges.data_ptr(), nbr_mask.data_ptr(),
                  _build.ptr(idx), b, m, n, f, _radius2(radius),
                  int(out_dtype == torch.bfloat16), p.centroids, p.points, MODES[mode],
                  _build.stream_of(pos))
    return idx, nbr_mask, edges
