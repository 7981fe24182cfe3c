"""Kernel 4: batched row gather, values (B, N, C) by idx (B, M, K) -> (B, M, K, C).

Forward of ``dl_biomass_tpu/ops/pallas_mxu_gather.py`` mxu_gather: the same
bits (its one-hot product is exact), and an index outside [0, N) gives a row
of zeros, as a one-hot row with no match does.

``gather_rows`` launches ``csrc/gather.cu`` on a CUDA tensor and runs
``gather_rows_plain`` on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from dl_biomass_tpu_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(values, idx):
    if values.dim() != 3 or idx.dim() != 3 or values.shape[0] != idx.shape[0]:
        raise ValueError(f"values must be (B, N, C) and idx (B, M, K), got "
                         f"{tuple(values.shape)} and {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError("idx must be int32 or int64")


def gather_rows_plain(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``index_select`` on the flattened rows."""
    _check(values, idx)
    b, n, c = values.shape
    ok = (idx >= 0) & (idx < n)
    base = torch.arange(b, device=values.device).view(b, 1, 1) * n
    src = (torch.where(ok, idx, 0) + base).reshape(-1)
    out = values.reshape(b * n, c).index_select(0, src).view(*idx.shape, c)
    return out.masked_fill(~ok[..., None], 0)


def _vec_bytes(row_bytes: int, *ptrs: int) -> int:
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    return 1


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (B, N, C), idx (B, M, K) -> (B, M, K, C) in the values' dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if values.device.type == "cpu":
        return gather_rows_plain(values, idx)
    if values.device.type != "cuda":
        raise RuntimeError(f"gather_rows runs on cuda or cpu tensors, got {values.device}")
    _check(values, idx)
    b, n, c = values.shape
    _, m, k = idx.shape
    values = values.contiguous()
    idx = idx.to(torch.int32).contiguous()
    _build.check_cuda("gather_rows", values, idx)
    out = torch.empty((b, m, k, c), dtype=values.dtype, device=values.device)
    row_bytes = c * values.element_size()
    vec = _vec_bytes(row_bytes, values.data_ptr(), out.data_ptr())
    _build.launch("dlbt_gather", _ARGTYPES, values.data_ptr(), idx.data_ptr(), out.data_ptr(),
                  b, m * k, n, row_bytes, vec, _build.stream_of(values))
    return out

