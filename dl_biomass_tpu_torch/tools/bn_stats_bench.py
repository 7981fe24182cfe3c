"""Formulations of the masked BatchNorm statistics at SA edge-tensor shapes
(port of the JAX package's ``tools/bn_stats_bench.py``).

The train-mode ``MaskedBatchNorm`` takes a masked one-pass sum and sum of
squares over the (B, M, 64) edge rows per channel. This times five ways to
compute them at SA1's (36, 2048, 64, 64) and SA2's (36, 512, 64, 128) edge
tensors: ``current`` (the one-pass form, also kernel 8's plain version),
``unmasked``, ``twostage`` (per-centroid partial sums first), ``bf16part``
(bf16 partial sums over the slots) and ``kernel``, kernel 8
(``csrc/masked_stats.cu``, whose blocks' slices ``dlbt_sum_slices`` adds)
in place of the TPU tool's Pallas kernel. Each
line gives ms, GB/s of x read and the largest relative error of s1 against
``current``.

    python -m dl_biomass_tpu_torch.tools.bn_stats_bench
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dl_biomass_tpu_torch.core.cloud import resolve_device
from dl_biomass_tpu_torch.ops import _build, sum_slices_kernel
from dl_biomass_tpu_torch.tools._timing import best_chain_s

LOOPS = 10  # calls per timed chain
WINDOWS = 3  # timed chains, best taken
SHAPES = (("SA1c64", (36, 2048, 64, 64)), ("SA2c128", (36, 512, 64, 128)))
BLOCKS_PER_SM = 8  # kernel 8's grid is at most this many blocks per SM
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2
             + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
DIMS = (0, 1, 2)


def stats_current(x: torch.Tensor, m3: torch.Tensor):
    """The masked one-pass sum and sum of squares, as ``MaskedBatchNorm`` takes
    them: kernel 8's plain version."""
    xf = x.float()
    xm = xf * m3[..., None].float()
    return xm.sum(DIMS), (xm * xf).sum(DIMS)


def stats_unmasked(x: torch.Tensor, m3: torch.Tensor):
    xf = x.float()
    return xf.sum(DIMS), (xf * xf).sum(DIMS)


def stats_twostage(x: torch.Tensor, m3: torch.Tensor):
    xf = x.float()
    xm = xf * m3[..., None].float()
    return xm.sum(2).sum((0, 1)), (xm * xf).sum(2).sum((0, 1))


def stats_bf16_partial(x: torch.Tensor, m3: torch.Tensor):
    """Partial sums over the slots in bf16 (64 terms, |x| ~ 1: ~1e-2
    relative), the final sum in float32."""
    xm = x * m3[..., None].to(x.dtype)
    p1 = xm.sum(2, dtype=x.dtype).float()
    p2 = (xm * x).sum(2, dtype=x.dtype).float()
    return p1.sum((0, 1)), p2.sum((0, 1))


def stats_slices(x: torch.Tensor, m3: torch.Tensor) -> torch.Tensor:
    """Kernel 8's own launch (``dlbt_masked_stats``), on CUDA tensors only:
    x (B, M, 64, C) bf16 and m3 (B, M, 64) bool -> its blocks' slices,
    (blocks, 2 * C) float32, each the block's s1 and then s2."""
    if x.device.type != "cuda":
        raise RuntimeError(f"stats_slices runs on cuda tensors, got {x.device}")
    if x.dim() != 4 or tuple(m3.shape) != tuple(x.shape[:3]) or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be (B, M, K, C) bf16 and m3 (B, M, K), got "
                         f"{tuple(x.shape)} {x.dtype} and {tuple(m3.shape)}")
    c = x.shape[-1]
    x = _build.aligned16(x.contiguous())
    m3 = m3.to(torch.bool).contiguous()
    _build.check_cuda("stats_kernel", x, m3)
    dev = x.device
    max_grid = BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty((max_grid, 2 * c), dtype=torch.float32, device=dev)
    grid = ctypes.c_int(0)
    _build.launch("dlbt_masked_stats", _ARGTYPES, x.data_ptr(), m3.data_ptr(),
                  partial.data_ptr(), m3.numel(), c, max_grid, ctypes.byref(grid),
                  _build.stream_of(x))
    return partial[:grid.value]


def stats_kernel(x: torch.Tensor, m3: torch.Tensor):
    """x (B, M, 64, C) bf16, m3 (B, M, 64) bool -> (s1, s2), each (C,) float32:
    ``sum(x m)`` and ``sum(x m x)`` over (B, M, 64), the mask multiplied in.

    A CPU tensor takes the plain version (``stats_current``); a CUDA tensor
    launches kernel 8 (``stats_slices``) and the sum of its blocks' slices
    (``sum_slices_kernel.sum_slices``)."""
    if x.device.type == "cpu":
        return stats_current(x, m3)
    if x.device.type != "cuda":
        raise RuntimeError(f"stats_kernel runs on cuda or cpu tensors, got {x.device}")
    out = sum_slices_kernel.sum_slices(stats_slices(x, m3)).view(2, -1)
    return out[0], out[1]


FORMULATIONS = (("current", stats_current), ("unmasked", stats_unmasked),
                ("twostage", stats_twostage), ("bf16part", stats_bf16_partial),
                ("kernel", lambda x, m3: stats_kernel(x, m3)))  # looked up at the call


def timed_ms(fn, x: torch.Tensor, m3: torch.Tensor) -> float:
    acc = torch.zeros((), dtype=torch.float32, device=x.device)

    def step():
        nonlocal acc
        s1, s2 = fn(x, m3)
        acc = acc + s1.sum() + s2.sum()

    return best_chain_s(step, x.device, LOOPS, WINDOWS) * 1e3


def main(device=None) -> list:
    """Time the five formulations at each shape of ``SHAPES``; prints a line
    each and returns them as dicts."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []
    for name, (b, m, k, c) in SHAPES:
        x = torch.from_numpy(rng.normal(size=(b, m, k, c)).astype(np.float32)).to(dev)
        x = x.to(torch.bfloat16)
        m3 = torch.from_numpy(rng.random(size=(b, m, k)) > 0.1).to(dev)
        gb = b * m * k * c * 2 / 1e9
        want = stats_current(x, m3)[0]
        for label, fn in FORMULATIONS:
            ms = timed_ms(fn, x, m3)
            row = dict(shape=name, label=label, ms=ms, gbps=gb / ms * 1e3)
            tag = ""
            if label != "unmasked":
                got = fn(x, m3)[0]
                row["max_rel_s1"] = float(((got - want).abs() / (want.abs() + 1e-3)).max())
                tag = f"  max_rel_s1={row['max_rel_s1']:.2e}"
            print(f"{name} {label:9s}: {ms:7.3f} ms  ({row['gbps']:6.1f} GB/s){tag}", flush=True)
            rows.append(row)
        del x, m3
    return rows


if __name__ == "__main__":
    main()
