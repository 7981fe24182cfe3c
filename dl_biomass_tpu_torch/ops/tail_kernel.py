"""Kernel 7: the fused tail of an SA layer, its last Linear and the masked max
over the 64 neighbour slots, forward and backward (port of
``dl_biomass_tpu/ops/pallas_tail.py`` fused_tail).

Forward: ``z = bf16(bf16(a2) bf16(W3) [float32 sum] + b3)``, then
``where(mask, z, -inf)``, its max over the slots (NaN if a valid slot's z
is NaN) and the first slot that equals the max; the output is 0 and the
argmax 64 (= K) on a row with no valid slot, and the argmax is 64 too where
no slot equals the max (a NaN max), as the TPU kernel forms it. Masking is a
true select, so NaN or Inf junk in ``a2`` at an invalid slot never reaches
the output. The (B, M, 64, C3) tensor z never reaches device memory.

Backward: the cotangent, rounded to bf16 (``gb``), goes to the argmax slot of
its column (an argmax of 64 routes nothing), and is contracted at once:
``da2 = bf16(gs W3^T)`` in a2's dtype, ``dW3 = a2^T gs`` with float32 sums.
``db3`` is the float32 sum of the cotangent over the rows whose argmax is
below 64, taken with torch ops outside the kernel as the JAX function takes it
with jnp. The mask gets no gradient, and an invalid slot gets exactly 0 where
W3 is finite. The plain version takes both products densely over the 64
slots, as the TPU kernel does; the kernel forms only the routed terms (each
slot's bucket of columns for da2, ``a2[am[c], j] gb[c]`` for dW3, on the CUDA
cores) and adds back the NaN that the dense sums make of 0 x NaN and 0 x Inf,
so that both are NaN or +-Inf at the same places.

``fused_tail_fwd`` and ``fused_tail_bwd`` launch ``csrc/fused_tail.cu``
(entries ``dlbt_fused_tail_fwd``; ``dlbt_fused_tail_bwd``, wrapper
``fused_tail_bwd_slices``, and then ``dlbt_sum_slices``, which adds the
blocks' dW3 slices: ``ops/sum_slices_kernel``) on a CUDA tensor and run
``fused_tail_fwd_plain`` and ``fused_tail_bwd_plain`` on a CPU tensor.
``fused_tail`` is the differentiable op, a ``torch.autograd.Function``
around the two. ``plan(c2, c3)`` names the forward's launch (wgmma or
mma.sync; warps, ring stages, shared memory, registers budgeted), mirroring
the source, and the wrapper raises where it gives None; with and without the
argmax a launch is of the same kind, so the two give the same output bits. ``probe`` (the forward's
measurement modes) and ``occupancy`` measure it, and no path calls them.
``bwd_plan(c2, c3)`` names the backward's launch at every width the forward
takes (its feature and column groups over gridDim.y, ring stages, shared
memory), the wrapper raises where it gives None, and ``fused_tail`` checks it
before its forward; ``probe_bwd`` and ``occupancy_bwd`` measure it.
Like the JAX function, it is wired into no model: the tool
``dl_biomass_tpu_torch.tools.tail_bench`` times it beside the unfused pair.
The kernels sum in their own order, so they agree with the plain versions to
float32 rounding of the sums (a bf16 value near a rounding boundary may round
one step the other way, and the argmax then move where two slots tie within
it). The TPU's M padding to a multiple of 8 and its tiling are not copied: any
M works.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from dl_biomass_tpu_torch.ops import _build, sum_slices_kernel
from dl_biomass_tpu_torch.ops.pooling import _max_only
from dl_biomass_tpu_torch.ops.sa_eval_kernel import _dot_f32

K = 64  # neighbour slots
_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# the forward's instantiations: the kernel, and its measurements (probe)
FWD_MODES = {"full": 0, "stage_only": 1, "mma_only": 2, "compute_only": 3}
# the forward's launch (csrc/fused_tail.cu): wgmma at these (C2, C3) (its
# instantiations: tail_bench's SA1 and SA2), two warpgroups; else mma.sync,
# warps of COLS output columns each, at most MAX_WARPS a block, rows C2 + SKEW
# apart; at most MAX_STAGES centroids in a block's ring
KINDS = {"mma": 0, "wgmma": 1}
COLS = 32
MAX_WARPS = 8
MAX_STAGES = 4
WGMMA_WIDTHS = ((64, 128), (128, 256))
WGMMA_WARPS = 8
SKEW = 8
SMEM_PER_BLOCK = 232448  # the shared memory a block may have on an H100 (227 KB)
SMEM_PER_SM = 233472  # an SM's, 228 KB, of which each block holds SMEM_RESERVED more
SMEM_RESERVED = 1024


class Plan(NamedTuple):
    kind: str  # "wgmma" or "mma" (KINDS)
    warps: int  # warps a block
    stages: int  # centroids in the block's shared-memory ring
    smem_bytes: int  # shared memory a block
    registers: int  # a lane's accumulators (and, on mma.sync, one step's B fragments)


_BWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
BLOCKS_PER_SM = 4  # the backward's grid is at most this many blocks per SM
# the backward's launch (csrc/fused_tail.cu): BWD_THREADS threads a block, each
# keeping at most BWD_MAX_COLS dW3 columns of 8 features (instantiations of 2,
# 4 and 8), at most BWD_MAX_STAGES centroids in a block's ring
BWD_THREADS = 256
BWD_MAX_COLS = 8
BWD_MAX_STAGES = 4
# the backward's instantiations: the kernel, and its measurements (probe_bwd)
BWD_MODES = {"full": 0, "stage_only": 1, "stage_da2": 2, "stage_dw3": 3}


class BwdPlan(NamedTuple):
    threads: int  # threads a block
    groups_j: int  # blocks sharing each centroid over gridDim.y, by features (dW3's rows)
    groups_c: int  # ... and by dW3's columns
    stages: int  # centroids in the block's shared-memory buffers
    smem_bytes: int  # shared memory a block
    registers: int  # a thread's dW3 accumulators


def _check(a2, nbr_mask, w3):
    if a2.dim() != 4 or a2.shape[2] != K or tuple(nbr_mask.shape) != tuple(a2.shape[:3]):
        raise ValueError(f"a2 must be (B, M, {K}, C2) and nbr_mask (B, M, {K}), got "
                         f"{tuple(a2.shape)} and {tuple(nbr_mask.shape)}")
    if w3.dim() != 2 or w3.shape[0] != a2.shape[3]:
        raise ValueError(f"w3 must be (C2, C3) = ({a2.shape[3]}, C3), got {tuple(w3.shape)}")


def _argmax(filled: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """The first slot equal to the max; K where no slot equals it (the max
    is NaN: a NaN at a valid slot) or where the max is -inf (no valid slot):
    the JAX kernel's rule, not ``first_argmax``'s 0."""
    lane = torch.arange(K, dtype=torch.int16, device=filled.device).view(1, 1, K, 1)
    am = torch.where(filled == raw.unsqueeze(2), lane, K).amin(dim=2).to(torch.int32)
    return torch.where(raw == float("-inf"), K, am)


def fused_tail_fwd_plain(a2: torch.Tensor, nbr_mask: torch.Tensor, w3: torch.Tensor,
                         b3: torch.Tensor, with_argmax: bool = False):
    """The plain PyTorch version: the unfused pair the JAX kernel mirrors, a
    bf16 product with a float32 sum plus ``b3`` rounded to bf16, then the
    masked max of ``ops/pooling``. Returns ``(out (B, M, C3) bf16, argmax
    (B, M, C3) int32 or None)``."""
    _check(a2, nbr_mask, w3)
    b, m, k, c2 = a2.shape
    z = _dot_f32(a2.reshape(-1, c2).to(torch.bfloat16), w3.to(torch.bfloat16))
    z = (z + b3.float()).to(torch.bfloat16).view(b, m, k, -1)
    filled, raw, _, out = _max_only(z, nbr_mask, dim=2)
    return out, (_argmax(filled, raw) if with_argmax else None)


def fused_tail_fwd(a2: torch.Tensor, nbr_mask: torch.Tensor, w3: torch.Tensor,
                   b3: torch.Tensor, with_argmax: bool = False):
    """a2 (B, M, 64, C2) bf16 (any dtype is rounded to bf16), nbr_mask (B, M, 64)
    bool, w3 (C2, C3) and b3 (C3,) float32 -> (out (B, M, C3) bf16, argmax
    (B, M, C3) int32 or None).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if a2.device.type == "cpu":
        return fused_tail_fwd_plain(a2, nbr_mask, w3, b3, with_argmax)
    return _launch_fwd(a2, nbr_mask, w3, b3, with_argmax, "full")


def plan(c2: int, c3: int) -> Optional[Plan]:
    """The forward's launch at widths (C2, C3), or None where the kernel takes
    none. At (C2, C3) = (64, 128) and (128, 256) it runs on wgmma (two
    warpgroups sharing each centroid, W3^T and the tiles in shared memory;
    the most stages that leave room for two blocks an SM). Elsewhere on
    mma.sync with W3^T in shared memory, the block's warps (at most
    MAX_WARPS) taking the 32-column slices in turn, and as many stages as
    fit, at most MAX_STAGES and at least 2."""
    if c2 < 16 or c3 < COLS or c2 % 16 or c3 % COLS:
        return None
    if (c2, c3) in WGMMA_WIDTHS:
        fits = [st for st in range(MAX_STAGES, 1, -1)
                if 2 * (smem_bytes(c2, c3, "wgmma", st) + SMEM_RESERVED) <= SMEM_PER_SM]
        stages = fits[0] if fits else 2
        return Plan("wgmma", WGMMA_WARPS, stages, smem_bytes(c2, c3, "wgmma", stages),
                    32 * (c3 // 128))
    for stages in range(MAX_STAGES, 1, -1):
        smem = smem_bytes(c2, c3, "mma", stages)
        if smem <= SMEM_PER_BLOCK:
            # 64 rows x 32 columns of accumulators over 32 lanes, and a step's B fragments
            return Plan("mma", min(c3 // COLS, MAX_WARPS), stages, smem, 64 + 8)
    return None


def smem_bytes(c2: int, c3: int, kind: str, stages: int) -> int:
    """A block's shared memory (the source's FwdLayout and WgLayout). mma.sync:
    W3^T in bf16 (C3 rows of C2 + 8), b3, and the ring, each buffer 64 rows of
    C2 + 8 bf16 and 64 slot flags. wgmma, from a base aligned to 1024 bytes
    inside the allocation: W3^T in bf16 (C3 rows of C2), the ring's tiles (64
    rows of C2 bf16), their 64 flags each, and b3."""
    if kind == "wgmma":
        return 2 * c3 * c2 + stages * (2 * K * c2 + K) + 4 * c3 + 1024
    return 2 * c3 * (c2 + SKEW) + 4 * c3 + stages * (2 * K * (c2 + SKEW) + K)


def launch_plan(c2: int, c3: int) -> Plan:
    """``plan(c2, c3)``, or ValueError where the kernel takes no such widths."""
    p = plan(c2, c3)
    if p is None:
        raise ValueError(f"fused_tail_fwd: the kernel takes no widths C2={c2}, C3={c3} (C2 a "
                         f"multiple of 16 and C3 of 32, whose W3^T and two buffers fit "
                         f"{SMEM_PER_BLOCK} bytes of shared memory)")
    return p


def probe(a2: torch.Tensor, nbr_mask: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor,
          mode: str) -> torch.Tensor:
    """The forward kernel on the card in a measurement ``mode`` (its own
    instantiation, on the launch ``plan`` names): "stage_only" (the copies into shared memory and the
    writing of the output, every output 0), "mma_only" (the copies and the
    products, a checksum of the accumulators written in place of the max) or
    "compute_only" (the products and the max, the ring filled once and never
    refilled: stale outputs); "full" is the kernel. No path calls it."""
    return _launch_fwd(a2, nbr_mask, w3, b3, False, mode)[0]


def occupancy(c2: int, c3: int, with_argmax: bool = False) -> dict:
    """``plan(c2, c3)``'s launch on the current card, with or without the
    argmax (its own instantiation): blocks per SM, threads and shared memory
    (bytes) a block, registers and local memory (bytes: spills) a thread."""
    p = launch_plan(c2, c3)
    fn = _build.library().dlbt_fused_tail_fwd_occupancy
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 5)()
    rc = fn(c2, c3, p.warps, p.stages, KINDS[p.kind], int(with_argmax), vals)
    if rc != 0:
        raise RuntimeError(f"dlbt_fused_tail_fwd_occupancy failed ({rc})")
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes", "registers", "local_bytes"),
                    list(vals)))


def _launch_fwd(a2, nbr_mask, w3, b3, with_argmax, mode):
    _check(a2, nbr_mask, w3)
    b, m, k, c2 = a2.shape
    c3 = w3.shape[1]
    p = launch_plan(c2, c3)
    if a2.device.type != "cuda":
        raise RuntimeError(f"fused_tail_fwd runs on cuda or cpu tensors, got {a2.device}")
    a2 = _build.aligned16(a2.to(torch.bfloat16).contiguous())
    nbr_mask = _build.aligned16(nbr_mask.to(torch.bool).contiguous())
    w3, b3 = w3.float().contiguous(), b3.float().contiguous()
    _build.check_cuda("fused_tail_fwd", a2, nbr_mask, w3, b3)
    out = torch.empty((b, m, c3), dtype=torch.bfloat16, device=a2.device)
    am = torch.empty((b, m, c3), dtype=torch.int32, device=a2.device) if with_argmax else None
    _build.launch("dlbt_fused_tail_fwd", _FWD_ARGTYPES, a2.data_ptr(), nbr_mask.data_ptr(),
                  w3.data_ptr(), b3.data_ptr(), out.data_ptr(), _build.ptr(am), b * m, c2, c3,
                  p.warps, p.stages, KINDS[p.kind], FWD_MODES[mode], _build.stream_of(a2))
    return out, am


def _routed(gb: torch.Tensor, am: torch.Tensor) -> torch.Tensor:
    """gb (B, M, C3) at the argmax slots -> (B, M, 64, C3) bf16; K routes nothing."""
    b, m, c3 = gb.shape
    gs = torch.zeros((b, m, K + 1, c3), dtype=torch.bfloat16, device=gb.device)
    gs.scatter_(2, am.long().unsqueeze(2), gb.to(torch.bfloat16).unsqueeze(2))
    return gs[:, :, :K]


def fused_tail_bwd_plain(a2: torch.Tensor, gb: torch.Tensor, am: torch.Tensor,
                         w3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the backward: the routed cotangent gs
    (B, M, 64, C3), ``da2 = bf16(gs W3^T)`` in a2's dtype and ``dW3 = a2^T gs``
    (C2, C3) float32, both bf16 products with float32 sums."""
    _check_bwd(a2, gb, am, w3)
    b, m, k, c2 = a2.shape
    gs = _routed(gb, am).reshape(-1, w3.shape[1])
    a2r = a2.reshape(-1, c2).to(torch.bfloat16)
    da2 = _dot_f32(gs, w3.to(torch.bfloat16).t()).to(a2.dtype).view(b, m, k, c2)
    return da2, _dot_f32(a2r.t(), gs)


def _check_bwd(a2, gb, am, w3):
    if a2.dim() != 4 or a2.shape[2] != K:
        raise ValueError(f"a2 must be (B, M, {K}, C2), got {tuple(a2.shape)}")
    b, m, _, c2 = a2.shape
    c3 = w3.shape[1]
    if (tuple(w3.shape) != (c2, c3) or tuple(gb.shape) != (b, m, c3)
            or tuple(am.shape) != (b, m, c3)):
        raise ValueError(f"gb and am must be (B, M, C3) = {(b, m, c3)} beside w3 (C2, C3), got "
                         f"{tuple(gb.shape)}, {tuple(am.shape)} and {tuple(w3.shape)}")


def bwd_plan(c2: int, c3: int) -> Optional[BwdPlan]:
    """The backward's launch at widths (C2, C3), or None where the kernel
    takes none (C2 a multiple of 16 and C3 of 32, as the forward). Each
    centroid is split over groups_j x groups_c blocks (gridDim.y): groups_j
    by features (each group J = C2 / groups_j of them, J / 8 a power of two
    up to 32),
    groups_c by dW3's columns (and da2's slots), the fewest column groups
    first, then the fewest feature groups, such that a thread keeps at most
    BWD_MAX_COLS columns of 8 features; then the most stages (at most
    BWD_MAX_STAGES) that leave room for two blocks an SM, else for one."""
    if c2 < 16 or c3 < 32 or c2 % 16 or c3 % 32:
        return None
    for groups_c in range(1, K + 1):
        for groups_j in (d for d in range(1, c2 // 8 + 1) if c2 // 8 % d == 0):
            jc = c2 // groups_j // 8  # 8-feature chunks a group
            if jc > 32 or jc & (jc - 1):
                continue
            cols = -(-(-(-c3 // groups_c)) // (BWD_THREADS // jc))
            if cols > BWD_MAX_COLS:
                continue
            sizes = {st: bwd_smem_bytes(c2, c3, groups_j, groups_c, st)
                     for st in range(BWD_MAX_STAGES, 1, -1)}
            two = [st for st, b in sizes.items() if 2 * (b + SMEM_RESERVED) <= SMEM_PER_SM]
            one = [st for st, b in sizes.items() if b <= SMEM_PER_BLOCK]
            if not (two or one):
                continue
            stages = (two or one)[0]
            nc = next(n for n in (2, 4, 8) if cols <= n)  # the instantiation
            return BwdPlan(BWD_THREADS, groups_j, groups_c, stages, sizes[stages], 8 * nc)
    return None


def bwd_smem_bytes(c2: int, c3: int, groups_j: int, groups_c: int, stages: int) -> int:
    """A backward block's shared memory (the source's BwdLayout): bf16(W3)^T
    held in float32 on the group's J = C2 / groups_j features (C3 rows of J),
    two counts per feature, two bucket tables (a 32-bit mask per 32 columns
    per slot of the group, its slots padded to a multiple of 4), and the
    ring, each buffer 64 rows of J + 8 bf16, the argmax (C3 int32) and the
    cotangent (C3 bf16)."""
    j = c2 // groups_j
    rows = (-(-K // groups_c) + 3) // 4 * 4
    return 4 * c3 * j + 8 * j + 8 * (c3 // 32) * rows + stages * (2 * K * (j + SKEW) + 6 * c3)


def launch_bwd_plan(c2: int, c3: int) -> BwdPlan:
    """``bwd_plan(c2, c3)``, or ValueError where the kernel takes no such widths."""
    p = bwd_plan(c2, c3)
    if p is None:
        raise ValueError(f"fused_tail_bwd: the kernel takes no widths C2={c2}, C3={c3} (C2 a "
                         f"multiple of 16 and C3 of 32)")
    return p


def probe_bwd(a2: torch.Tensor, gb: torch.Tensor, am: torch.Tensor, w3: torch.Tensor,
              mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel on the card in a measurement ``mode`` (its own
    instantiation, on the launch ``bwd_plan`` names): "stage_only" (the
    copies into shared memory, da2 written as zeros, no products),
    "stage_da2" (the copies and da2, no dW3) or "stage_dw3" (the copies and
    dW3, da2 written as zeros); "full" is the kernel. Returns (da2, slices)
    as ``fused_tail_bwd_slices``. No path calls it."""
    return _launch_bwd(a2, gb, am, w3, mode)


def occupancy_bwd(c2: int, c3: int) -> dict:
    """``bwd_plan(c2, c3)``'s launch on the current card: blocks per SM,
    threads and shared memory (bytes) a block, registers and local memory
    (bytes: spills) a thread."""
    p = launch_bwd_plan(c2, c3)
    fn = _build.library().dlbt_fused_tail_bwd_occupancy
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 5)()
    rc = fn(c2, c3, p.threads, p.groups_j, p.groups_c, p.stages, vals)
    if rc != 0:
        raise RuntimeError(f"dlbt_fused_tail_bwd_occupancy failed ({rc})")
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes", "registers", "local_bytes"),
                    list(vals)))


def fused_tail_bwd_slices(a2: torch.Tensor, gb: torch.Tensor, am: torch.Tensor,
                          w3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's first launch (``dlbt_fused_tail_bwd``), on CUDA tensors
    only: da2 and the blocks' dW3 slices, (blocks, C2 * C3) float32, each the
    sum over its block's centroids."""
    return _launch_bwd(a2, gb, am, w3, "full")


def _launch_bwd(a2, gb, am, w3, mode):
    _check_bwd(a2, gb, am, w3)
    b, m, _, c2 = a2.shape
    c3 = w3.shape[1]
    p = launch_bwd_plan(c2, c3)
    if a2.device.type != "cuda":
        raise RuntimeError(f"fused_tail_bwd_slices runs on cuda tensors, got {a2.device}")
    if a2.dtype != torch.bfloat16:
        raise ValueError(f"a2 must be bf16, got {a2.dtype}")
    dev = a2.device
    a2 = _build.aligned16(a2.contiguous())
    gb = _build.aligned16(gb.to(torch.bfloat16).contiguous())
    am = _build.aligned16(am.to(torch.int32).contiguous())
    w3 = _build.aligned16(w3.float().contiguous())
    _build.check_cuda("fused_tail_bwd", a2, gb, am, w3)
    max_grid = BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty((max_grid, c2 * c3), dtype=torch.float32, device=dev)
    da2 = torch.empty_like(a2)
    grid = ctypes.c_int(0)
    _build.launch("dlbt_fused_tail_bwd", _BWD_ARGTYPES, a2.data_ptr(), gb.data_ptr(),
                  am.data_ptr(), w3.data_ptr(), partial.data_ptr(), da2.data_ptr(), b * m, c2,
                  c3, p.threads, p.groups_j, p.groups_c, p.stages, max_grid, BWD_MODES[mode],
                  ctypes.byref(grid), _build.stream_of(a2))
    return da2, partial[:grid.value]


def fused_tail_bwd(a2: torch.Tensor, gb: torch.Tensor, am: torch.Tensor,
                   w3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a2 (B, M, 64, C2) bf16, gb (B, M, C3) bf16, am (B, M, C3) the forward's
    argmax, w3 (C2, C3) float32 -> (da2 (B, M, 64, C2) bf16, dW3 (C2, C3) float32).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``fused_tail_bwd_slices``) and the sum of its blocks' dW3 slices
    (``sum_slices_kernel.sum_slices``)."""
    if a2.device.type == "cpu":
        return fused_tail_bwd_plain(a2, gb, am, w3)
    if a2.device.type != "cuda":
        raise RuntimeError(f"fused_tail_bwd runs on cuda or cpu tensors, got {a2.device}")
    da2, slices = fused_tail_bwd_slices(a2, gb, am, w3)
    return da2, sum_slices_kernel.sum_slices(slices).view(w3.shape)


class _FusedTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a2, nbr_mask, w3, b3):
        out, am = fused_tail_fwd(a2, nbr_mask, w3, b3, with_argmax=True)
        ctx.save_for_backward(a2, am, w3)
        ctx.b3_dtype = b3.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        a2, am, w3 = ctx.saved_tensors
        da2, dw3 = fused_tail_bwd(a2.to(torch.bfloat16), g.to(torch.bfloat16), am, w3)
        db3 = torch.where(am < K, g.float(), 0.0).sum(dim=(0, 1))  # from the f32 cotangent
        return da2.to(a2.dtype), None, dw3.to(w3.dtype), db3.to(ctx.b3_dtype)


def fused_tail(a2: torch.Tensor, nbr_mask: torch.Tensor, w3: torch.Tensor,
               b3: torch.Tensor) -> torch.Tensor:
    """``masked_max(Dense(a2), nbr_mask, dim=2)`` in bf16 without z in device
    memory: (B, M, 64, C2) -> (B, M, C3) bf16, differentiable in a2, w3 and
    b3. Without a gradient to take, the forward skips the argmax."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a2, w3, b3)):
        if a2.device.type != "cpu":  # never a forward whose backward the kernel refuses
            launch_bwd_plan(a2.shape[-1], w3.shape[-1])
        return _FusedTail.apply(a2, nbr_mask, w3, b3)
    return fused_tail_fwd(a2, nbr_mask, w3, b3)[0]
