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
value near a rounding boundary may round one step the other way). The Pallas
kernel's private ``stage=`` timing bisect is a TPU profiling aid and is not
ported.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from dl_biomass_tpu_torch.core.cloud import round_up
from dl_biomass_tpu_torch.ops import _build
from dl_biomass_tpu_torch.ops.ball_group_kernel import _radius2, ball_group_plain
from dl_biomass_tpu_torch.ops.pooling import masked_max

IN_PAD = 8  # the kernel's layer-1 input width: F + 3 <= 8
WIDTH_STEP = 64  # the kernel's hidden and output widths are multiples of 64
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


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
                         radius: float, bf16: bool = False, out_dtype=torch.float32):
    """The plain PyTorch version: ``ball_group_plain``, the three folded layers,
    ``masked_max``."""
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


def _pad(w: torch.Tensor, *size: int) -> torch.Tensor:
    """``w`` zero-padded at the end of each dimension to ``size``."""
    pads = []
    for have, want in zip(reversed(w.shape), reversed(size)):
        pads += [0, want - have]
    return F.pad(w, pads)


def sa1_fused_eval(centers: torch.Tensor, center_mask: torch.Tensor, pos: torch.Tensor,
                   mask: torch.Tensor, feat: Optional[torch.Tensor],
                   folded_weights: Sequence[torch.Tensor], *, radius: float, bf16: bool = False,
                   out_dtype=torch.float32) -> torch.Tensor:
    """centers (B, M, 3), center_mask (B, M), pos (B, N, 3), mask (B, N), feat
    (B, N, F) with F <= 4 or None; ``folded_weights`` = [w1 (F+3, H1), b1, w2
    (H1, H2), b2, w3 (H2, C), b3] -> (B, M, C) in ``out_dtype``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    The kernel keeps the weights in a block's shared memory, which holds the
    production widths (64, 64, 128) but not twice them: its launch is refused
    (RuntimeError) for widths that do not fit."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if pos.device.type == "cpu":
        return sa1_fused_eval_plain(centers, center_mask, pos, mask, feat, folded_weights,
                                    radius=radius, bf16=bf16, out_dtype=out_dtype)
    if pos.device.type != "cuda":
        raise RuntimeError(f"sa1_fused_eval runs on cuda or cpu tensors, got {pos.device}")
    f = 0 if feat is None else feat.shape[-1]
    if f + 3 > IN_PAD:
        raise ValueError(f"sa1_fused_eval takes at most {IN_PAD - 3} features, got {f}")
    (w1, b1), (w2, b2), (w3, b3) = _layers(folded_weights, f)
    b, m, _ = centers.shape
    n = pos.shape[1]
    c = w3.shape[1]
    h1p, h2p, cp = (round_up(w.shape[1], WIDTH_STEP) for w in (w1, w2, w3))
    ct = torch.bfloat16 if bf16 else torch.float32

    def rounded(w):  # the compute type's values, carried as float32
        return w.to(ct).float()

    weights = torch.cat([
        _pad(rounded(w1), IN_PAD, h1p).reshape(-1), _pad(b1, h1p),
        _pad(rounded(w2), h1p, h2p).reshape(-1), _pad(b2, h2p),
        _pad(rounded(w3), h2p, cp).reshape(-1), _pad(b3, cp)]).to(pos.device)
    planes = pos.transpose(1, 2) if feat is None else torch.cat([pos, feat.float()],
                                                                -1).transpose(1, 2)
    planes = planes.contiguous()  # (B, 3+F, N): x, y, z, features
    centers, center_mask, mask = centers.contiguous(), center_mask.contiguous(), mask.contiguous()
    _build.check_cuda("sa1_fused_eval", centers, center_mask, planes, mask, weights)
    out = torch.empty((b, m, c), dtype=out_dtype, device=pos.device)
    _build.launch("dlbt_sa1_fused_eval", _ARGTYPES, centers.data_ptr(), center_mask.data_ptr(),
                  planes.data_ptr(), mask.data_ptr(), weights.data_ptr(), out.data_ptr(),
                  b, m, n, f, h1p, h2p, cp, c, _radius2(radius), int(bf16),
                  int(out_dtype == torch.bfloat16), _build.stream_of(pos))
    return out
