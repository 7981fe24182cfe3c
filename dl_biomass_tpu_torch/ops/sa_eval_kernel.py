"""Kernel 5: the whole SA1 eval layer in one kernel (port of
``dl_biomass_tpu/ops/pallas_sa_eval.py`` sa1_fused_eval).

Stratified selection and capture (the rule of kernel 2,
``ops/ball_group_kernel.py``), the folded MLP ``(F+3) -> H1 -> H2 -> C``
(BatchNorm folded into the weights, as the serving engine folds it) and the
masked max over the 64 slots, emitting only the (B, M, C) pooled rows. The
numerics are the engine's ``_run_folded`` at the same ``bf16`` flag: edge
values and weights rounded to the compute type, dot products with float32
accumulation plus a float32 bias, ReLU and rounding on the hidden layers, the
last layer float32 into the max; 0 where no slot is valid.

``sa1_fused_eval`` launches ``csrc/sa1_fused_eval.cu`` on a CUDA tensor and
runs ``sa1_fused_eval_plain`` (kernel 2's plain version, the three layers
and ``masked_max``) on a CPU tensor. The kernel sums each dot product in its
own order (bf16 on the tensor cores, float32 in FMAs on the CUDA cores), so it
agrees with the plain version to float32 rounding of the sums (bf16: a hidden
value near a rounding boundary may round one step the other way). The kernel
keeps the weights in a block's shared memory in the layout ``pack_sa1_eval``
gives them, made once (the serving engine packs when it is built) and handed
in as ``packed=``; without it the wrapper packs for itself. ``plan`` names
the kernel's launch at any widths and input width, as ``csrc/sa1_fused_eval.cu``
``plan_of`` does: SA1's at ``neuron_multiplier`` 1, 2 and 3 on the resident
kernels (bf16 at F <= 13, f32 at F <= 5), every other width and F on the wide
kernel, which streams the weights in tiles and keeps a1 and a2 in shared
memory or, where they do not fit there, in a scratch tensor the wrapper
allocates. ``selection_only`` (the kernel's scan and capture alone) and
``occupancy`` measure the kernel; no path calls them. The Pallas kernel's
private ``stage=`` timing bisect is a TPU profiling aid and is not ported.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence

import torch

from dl_biomass_tpu_torch.core.cloud import round_up
from dl_biomass_tpu_torch.ops import _build
from dl_biomass_tpu_torch.ops.ball_group_kernel import _radius2, ball_group_plain
from dl_biomass_tpu_torch.ops.pooling import masked_max

IN_PAD = 8  # the f32 kernels' layer-1 depth step: F + 3 in whole steps of 8
MMA_DEPTH = 16  # the bf16 kernels' layer-1 depth step: F + 3 in whole MMA steps of 16
SKEW_H = 8  # csrc/mma_bf16.cuh kSkewH: each bf16 weight row is this many values longer
WIDTH_STEP = 64  # the kernel's hidden and output widths are multiples of 64
# the launch (csrc/sa1_fused_eval.cu plan_of): a block's shared memory on the H100
# (the kernel asks the card), the bf16 kernel's four 128-thread groups a block and
# the hidden widths it takes, each part of a layout rounded up to 16 bytes
SMEM_MAX = 232448
GROUP, GROUPS = 128, 4
MMA_WIDTHS = (64, 128, 192)
F32_SKEW = 4  # f32 rows of the edge, a1 and a2 are (width + 4) floats apart
SLOTS = 64
TILE = 64  # the wide kernel's weight tiles: 64 output columns, at most 64 deep
# the wide kernel's grid where a1 and a2 are in scratch: at most this many blocks an SM
# (the launch's max_grid), each with its slice of the scratch tensor
WIDE_BLOCKS_PER_SM = 8
_ROUTE = "ROADMAP C.2"
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 8
             + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def in_depth(f: int, bf16: bool) -> int:
    """Layer 1's depth in the kernels at ``f`` features: F + 3 in whole MMA
    steps, 16 in bf16 and 8 in float32."""
    return round_up(f + 3, MMA_DEPTH if bf16 else IN_PAD)


def _layers(folded_weights: Sequence[torch.Tensor], f: int):
    w1, b1, w2, b2, w3, b3 = [w.float() for w in folded_weights]
    if w1.shape[0] != f + 3:
        raise ValueError(f"w1 rows {w1.shape[0]} != features+3 ({f + 3})")
    return [(w1, b1), (w2, b2), (w3, b3)]


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (R, Cin) @ w (Cin, Cout) of one dtype with a float32 product (the
    models' ``dot_f32`` numerics; ``ops`` does not import ``models``); float64
    operands keep a float64 product."""
    if x.dtype in (torch.float32, torch.float64):
        return x @ w
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def sa1_fused_eval_plain(centers, center_mask, pos, mask, feat, folded_weights, *,
                         radius: float, bf16: bool = False, out_dtype=torch.float32,
                         packed=None):
    """The plain PyTorch version: ``ball_group_plain``, the three folded layers,
    ``masked_max``; ``packed``, the kernel's weight block, is not read."""
    f = 0 if feat is None else feat.shape[-1]
    layers = _layers(folded_weights, f)
    ct = torch.bfloat16 if bf16 else torch.float32
    _, nbr_mask, x = ball_group_plain(centers, center_mask, pos, mask, feat, radius=radius,
                                      out_dtype=ct, need_idx=False)
    shp = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    for i, (w, b) in enumerate(layers):
        y = _dot_f32(x.to(ct), w.to(ct)) + b
        x = y.relu().to(ct) if i < len(layers) - 1 else y
    return masked_max(x.view(*shp, -1), nbr_mask, dim=2).to(out_dtype)


def _block_parts(h1: int, h2: int, c: int, bf16: bool, d1: Optional[int] = None):
    """The weight block's parts in order, (dtype, shape) each, at padded widths
    (``csrc/sa1_fused_eval.cu`` ``Weights``): in bf16 W1^T (H1, D1 + SKEW_H),
    b1 (H1), W2^T (H2, H1 + SKEW_H), b2, W3^T (C, H2 + SKEW_H), b3, the
    matrices bf16 and the biases float32; in float32 w1 (D1, H1), b1, w2 (H1,
    H2), b2, w3 (H2, C), b3. D1 is layer 1's depth (``in_depth``; None: 16 in
    bf16, 8 in float32, that of up to 13 and 5 features)."""
    f32 = torch.float32
    if bf16:
        bf, d1 = torch.bfloat16, d1 or MMA_DEPTH
        return [(bf, (h1, d1 + SKEW_H)), (f32, (h1,)), (bf, (h2, h1 + SKEW_H)),
                (f32, (h2,)), (bf, (c, h2 + SKEW_H)), (f32, (c,))]
    return [(f32, (d1 or IN_PAD, h1)), (f32, (h1,)), (f32, (h1, h2)), (f32, (h2,)),
            (f32, (h2, c)), (f32, (c,))]


def block_bytes(h1: int, h2: int, c: int, bf16: bool, d1: Optional[int] = None) -> int:
    """Bytes of the weight block at these padded widths and layer-1 depth."""
    return sum(math.prod(shape) * (2 if dt == torch.bfloat16 else 4)
               for dt, shape in _block_parts(h1, h2, c, bf16, d1))


def _parts_bytes(*sizes: int) -> int:
    return sum(-(-x // 16) * 16 for x in sizes)


# a group of the bf16 kernel: its four centroids' bucket minima, the ballots of
# their valid slots (two each), their edge rows (bf16, MMA_DEPTH + SKEW_H apart)
GROUP_BYTES = _parts_bytes(4 * 4 * GROUP, 4 * 2 * 4, 2 * 4 * SLOTS * (MMA_DEPTH + SKEW_H))


def _fma_bytes(h1: int, h2: int, c: int, stream: bool) -> int:
    """The f32 kernel's shared memory: the weight block (resident) or W1, the
    biases and two 64-column buffers of W2 or W3 (streamed), then the edge
    rows, a1, a2, the four warps' column maxima, the slots' flags and the
    bucket minima."""
    weights = (_parts_bytes(4 * IN_PAD * h1, 4 * h1, 4 * h2, 4 * c,
                            *(2 * [4 * max(h1, h2) * 64])) if stream
               else block_bytes(h1, h2, c, False))
    return weights + _parts_bytes(4 * SLOTS * (IN_PAD + F32_SKEW), 4 * SLOTS * (h1 + F32_SKEW),
                                  4 * SLOTS * (h2 + F32_SKEW), 4 * 4 * c, 4 * SLOTS, 4 * GROUP)


def _wide_bytes(bf16: bool, d1: int, h1: int, h2: int, scratch: bool):
    """The wide kernel's shared memory and scratch slice a block (``Wide``): the
    bucket minima, the slots' flags, the edge rows, the warps' maxima of a
    64-column chunk, two weight tiles, then a1 and a2 (64 rows each) there or,
    with ``scratch``, in the block's slice."""
    e, skew = (2, SKEW_H) if bf16 else (4, F32_SKEW)
    tile = 2 * TILE * (TILE + SKEW_H) if bf16 else 4 * TILE * TILE
    smem = _parts_bytes(4 * GROUP, 4 * SLOTS, e * SLOTS * (d1 + skew), 4 * 4 * TILE, tile, tile)
    acts = _parts_bytes(e * SLOTS * (h1 + skew), e * SLOTS * (h2 + skew))
    return (smem, acts) if scratch else (smem + acts, 0)


class Plan(NamedTuple):
    # "mma" (bf16), "fma" (f32, resident weights), "fma_stream" (f32, W2 and W3
    # streamed) or "wide" (either dtype, every weight streamed in tiles)
    kernel: str
    column_groups: int  # gridDim.y: layer 3's columns split over the blocks
    smem_bytes: int  # shared memory a block
    scratch_bytes: int = 0  # the wide kernel's a1 and a2 a block, where they are in scratch


def plan(h1: int, h2: int, c: int, bf16: bool, f: int = 1) -> Optional[Plan]:
    """The kernel's launch at these padded widths (multiples of 64) and ``f``
    features, or None where it takes none. bf16: H1 = H2 in (64, 128, 192), C =
    2 H1 and F <= 13, SA1's widths at neuron_multiplier 1, 2 and 3, on the
    resident kernel, four groups a block; at 192 layer 3's columns in two halves
    over gridDim.y, as the whole weight block does not fit. f32 at F <= 5: the
    weight block resident where it fits SMEM_MAX beside the buffers, else W2 and
    W3 streamed where that fits. Everything else: the wide kernel, a1 and a2 in
    shared memory where they fit, else in scratch."""
    if f < 0 or min(h1, h2, c) < 1 or any(w % WIDTH_STEP for w in (h1, h2, c)):
        return None
    d1 = in_depth(f, bf16)
    if bf16 and d1 == MMA_DEPTH and h2 == h1 and c == 2 * h1 and h1 in MMA_WIDTHS:
        cols = 2 if h1 == 192 else 1
        smem = block_bytes(h1, h2, c // cols, True) + GROUPS * GROUP_BYTES
        if smem <= SMEM_MAX:
            return Plan("mma", cols, smem)
    if not bf16 and d1 == IN_PAD:
        for kernel, stream in (("fma", False), ("fma_stream", True)):
            if _fma_bytes(h1, h2, c, stream) <= SMEM_MAX:
                return Plan(kernel, 1, _fma_bytes(h1, h2, c, stream))
    scratch = _wide_bytes(bf16, d1, h1, h2, False)[0] > SMEM_MAX
    smem, slice_bytes = _wide_bytes(bf16, d1, h1, h2, scratch)
    return Plan("wide", 1, smem, slice_bytes) if smem <= SMEM_MAX else None


def padded_widths(folded_weights: Sequence[torch.Tensor]):
    """(H1, H2, C) of the folded weights, each rounded up to WIDTH_STEP."""
    return tuple(round_up(folded_weights[i].shape[1], WIDTH_STEP) for i in (0, 2, 4))


def check_widths(folded_weights: Sequence[torch.Tensor], bf16: bool) -> Plan:
    """``plan`` of the folded weights' widths and input width; raises
    ``NotImplementedError`` (citing ROADMAP C.2) where the kernel takes none: a
    width not fitting even the wide kernel's shared memory, which no width of
    SA1 at ``neuron_multiplier`` 1-32 and 1-16 features reaches."""
    f = folded_weights[0].shape[0] - 3
    widths = padded_widths(folded_weights)
    p = plan(*widths, bf16, f=f)
    if p is None:
        raise NotImplementedError(
            f"sa1_fused_eval (kernel 5) takes no SA1 of input width {f + 3} and widths "
            f"{tuple(folded_weights[i].shape[1] for i in (0, 2, 4))} (padded {widths}) in "
            f"{'bf16' if bf16 else 'float32'}: {_ROUTE}")
    return p


def pack_sa1_eval(folded_weights: Sequence[torch.Tensor], bf16: bool, device) -> torch.Tensor:
    """The kernel's weight block for the folded weights [w1 (F+3, H1), b1, w2
    (H1, H2), b2, w3 (H2, C), b3], made once (the serving engine packs it when
    it is built): flat bytes (uint8) on ``device`` in the layout the kernel
    reads (``_block_parts``), the widths zero-padded to 64 and layer 1's depth
    to ``in_depth``, each matrix rounded to the compute type (bf16: transposed,
    each row ``SKEW_H`` zeros longer), every part a whole number of 16 bytes."""
    w1, b1, w2, b2, w3, b3 = [w.detach().float().to(device) for w in folded_weights]
    h1p, h2p, cp = (round_up(w.shape[1], WIDTH_STEP) for w in (w1, w2, w3))
    d1 = in_depth(w1.shape[0] - 3, bf16)
    parts = []
    for (dt, shape), w in zip(_block_parts(h1p, h2p, cp, bf16, d1), (w1, b1, w2, b2, w3, b3)):
        if bf16 and w.dim() == 2:
            w = w.t()  # (out, in): the kernel's B fragments are its rows
        part = torch.zeros(shape, dtype=dt, device=device)
        part[tuple(slice(0, k) for k in w.shape)] = w.to(dt)
        parts.append(part.reshape(-1).view(torch.uint8))
    return torch.cat(parts)


def _check_block(packed: torch.Tensor, h1: int, h2: int, c: int, bf16: bool, d1: int,
                 device) -> None:
    n = block_bytes(h1, h2, c, bf16, d1)
    if (packed.dtype != torch.uint8 or packed.numel() != n or packed.device != device
            or not packed.is_contiguous()):
        raise ValueError(f"sa1_fused_eval: the packed block holds {packed.numel()} "
                         f"{packed.dtype} on {packed.device}; widths {(h1, h2, c)} and depth "
                         f"{d1} in {'bf16' if bf16 else 'float32'} need {n} contiguous uint8 "
                         f"on {device}")


def _launch(entry: str, centers, center_mask, pos, mask, feat, folded_weights, radius, bf16,
            out_dtype, packed):
    if pos.device.type != "cuda":
        raise RuntimeError(f"sa1_fused_eval runs on cuda or cpu tensors, got {pos.device}")
    f = 0 if feat is None else feat.shape[-1]
    _layers(folded_weights, f)  # raises unless w1 takes F + 3 rows
    p = check_widths(folded_weights, bf16)
    b, m, _ = centers.shape
    n = pos.shape[1]
    c = folded_weights[4].shape[1]
    h1p, h2p, cp = padded_widths(folded_weights)
    if packed is None:
        packed = pack_sa1_eval(folded_weights, bf16, pos.device)
    _check_block(packed, h1p, h2p, cp, bf16, in_depth(f, bf16), pos.device)
    planes = pos.transpose(1, 2) if feat is None else torch.cat([pos, feat.float()],
                                                                -1).transpose(1, 2)
    planes = planes.contiguous()  # (B, 3+F, N): x, y, z, features
    centers, center_mask, mask = centers.contiguous(), center_mask.contiguous(), mask.contiguous()
    packed = _build.aligned16(packed)
    _build.check_cuda("sa1_fused_eval", centers, center_mask, planes, mask, packed)
    out = torch.empty((b, m, c), dtype=out_dtype, device=pos.device)
    max_grid, scratch = 1, None
    if p.scratch_bytes:  # the wide kernel's a1 and a2: a slice a block
        max_grid = WIDE_BLOCKS_PER_SM * torch.cuda.get_device_properties(
            pos.device).multi_processor_count
        scratch = torch.empty(max_grid * p.scratch_bytes, dtype=torch.uint8, device=pos.device)
    _build.launch(entry, _ARGTYPES, centers.data_ptr(), center_mask.data_ptr(),
                  planes.data_ptr(), mask.data_ptr(), packed.data_ptr(), out.data_ptr(),
                  _build.ptr(scratch), 0 if scratch is None else scratch.numel(),
                  b, m, n, f, h1p, h2p, cp, c, _radius2(radius), int(bf16),
                  int(out_dtype == torch.bfloat16), max_grid, _build.stream_of(pos))
    return out


def sa1_fused_eval(centers: torch.Tensor, center_mask: torch.Tensor, pos: torch.Tensor,
                   mask: torch.Tensor, feat: Optional[torch.Tensor],
                   folded_weights: Sequence[torch.Tensor], *, radius: float, bf16: bool = False,
                   out_dtype=torch.float32, packed: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """centers (B, M, 3), center_mask (B, M), pos (B, N, 3), mask (B, N), feat
    (B, N, F) or None; ``folded_weights`` = [w1 (F+3, H1), b1, w2
    (H1, H2), b2, w3 (H2, C), b3] -> (B, M, C) in ``out_dtype``. ``packed``:
    ``pack_sa1_eval`` of the same weights at the same ``bf16``, made here when
    not given; a block of other widths, compute type or device raises
    ``ValueError``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel as
    ``plan`` names it (the widths padded to 64) and raises
    ``NotImplementedError`` where it names none."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if pos.device.type == "cpu":
        return sa1_fused_eval_plain(centers, center_mask, pos, mask, feat, folded_weights,
                                    radius=radius, bf16=bf16, out_dtype=out_dtype)
    return _launch("dlbt_sa1_fused_eval", centers, center_mask, pos, mask, feat, folded_weights,
                   radius, bf16, out_dtype, packed)


def selection_only(centers, center_mask, pos, mask, feat, folded_weights, *, radius: float,
                   bf16: bool = False, packed=None) -> torch.Tensor:
    """The kernel's selection and capture alone, on the card: (B, M, C)
    float32, each row the count of its centroid's valid slots (0 where none).
    A measurement of the scan's share of the kernel; no path runs it."""
    return _launch("dlbt_sa1_fused_eval_select", centers, center_mask, pos, mask, feat,
                   folded_weights, radius, bf16, torch.float32, packed)


def occupancy(bf16: bool, h1: int, h2: int, c: int, f: int = 1) -> dict:
    """The kernel's launch at these padded widths and ``f`` features on the
    current card, as its C side plans it: the kernel (``Plan.kernel``), column
    groups, threads and shared memory per block (bytes), blocks per SM, the
    wide kernel's scratch bytes a block, and the built kernel's registers and
    local memory (spill) a thread."""
    fn = _build.library().dlbt_sa1_fused_eval_occupancy
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 8
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(8)]
    rc = fn(f, int(bf16), h1, h2, c, *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"dlbt_sa1_fused_eval_occupancy failed ({rc})")
    kind, cols, per_sm, threads, smem, slice_bytes, regs, local = (x.value for x in out)
    return dict(kernel={1: "mma", 2: "fma", 3: "fma_stream", 4: "wide"}[kind],
                column_groups=cols, blocks_per_sm=per_sm, threads=threads, smem_bytes=smem,
                scratch_bytes=slice_bytes, registers=regs, local_bytes=local)
