"""The cross-block step of kernels 7-B and 8 (``csrc/sum_slices.cu``): the
float32 slices that a kernel's blocks write, added in block order in float64
and rounded once to float32, so the sum repeats bit for bit without float
atomics. ``sum_slices`` launches ``dlbt_sum_slices`` on a CUDA tensor and runs
``sum_slices_plain`` on a CPU tensor."""

from __future__ import annotations

import ctypes

import torch

from dl_biomass_tpu_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def sum_slices_plain(slices: torch.Tensor) -> torch.Tensor:
    """The plain version: the slices added in float64."""
    return slices.double().sum(0).float()


def sum_slices(slices: torch.Tensor) -> torch.Tensor:
    """(blocks, n) float32 -> (n,) float32, the slices added in block order in
    float64."""
    if slices.device.type == "cpu":
        return sum_slices_plain(slices)
    if slices.device.type != "cuda":
        raise RuntimeError(f"sum_slices runs on cuda or cpu tensors, got {slices.device}")
    if slices.dim() != 2 or slices.dtype != torch.float32:
        raise ValueError(f"slices must be (blocks, n) float32, got {tuple(slices.shape)} "
                         f"{slices.dtype}")
    slices = slices.contiguous()
    _build.check_cuda("sum_slices", slices)
    out = torch.empty(slices.shape[1], dtype=torch.float32, device=slices.device)
    _build.launch("dlbt_sum_slices", _ARGTYPES, slices.data_ptr(), out.data_ptr(),
                  slices.shape[0], slices.shape[1], _build.stream_of(slices))
    return out
