"""Kernel 4: batched row gather, values (B, N, C) by idx (B, M, K) -> (B, M, K, C),
its scatter-add backward, and the gather of a second, gradient-free table.

Forward (4a) of ``dl_biomass_tpu/ops/pallas_mxu_gather.py`` mxu_gather: the
same bits (its one-hot product is exact), and an index outside [0, N) gives a
row of zeros, as a one-hot row with no match does.

Aux table (4c), ``mxu_gather(values, idx, aux=aux)`` (``_core2``): one index
gathers the values and an f32 ``aux`` (B, N, C2) table (SA2's positions beside
its features) into two outputs; d/dvalues is the backward below and aux gets
no gradient (``_core2_bwd``). Rows are copied, so the kernel and its plain
version agree bit for bit. A divergence by design: the TPU's compiled path
rebuilds f32 aux from three bf16 chunks, to 2^-21 relative; the JAX package
in interpret mode and the port gather it exactly. The hi/mid/lo packing, the
128-lane padding and the M-split are TPU layout and are not copied.

Backward (4b), ``_gather_bwd``/``_bwd_kernel``: each row of d/dvalues is the
float32 sum of the cotangent rows whose index points at it, rounded once to
the cotangent's dtype; an index outside [0, N) contributes nothing, and a pad
slot (index 0) contributes its cotangent (zero on the model's path). The sum
runs in ascending flat-row order, so the kernel and its plain version agree
bit for bit and a run repeats exactly: no float atomics. ``scatter_plan``
names the kernel's launch (the blocks a cloud of its count and place passes,
the warps a place block) and the wrapper raises where it gives None;
``probe`` runs one of its four launches alone, a measurement no path makes.

``gather_rows`` is the differentiable op the model calls. Its forward is
``gather_rows_forward`` (``gather_rows_aux`` with an aux table) and its
backward ``scatter_rows``: each launches its CUDA kernel (``csrc/gather.cu``
entries ``dlbt_gather`` and ``dlbt_gather_aux``, ``csrc/gather_bwd.cu``) on a
CUDA tensor and runs its plain version (``gather_rows_plain``,
``gather_rows_aux_plain``, ``scatter_rows_plain``) on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from dl_biomass_tpu_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_AUX_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_PROBE_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's count and place passes (csrc/gather_bwd.cu): a block takes
# CSR_ROWS rows of a cloud; a place block keeps the chunk's keys, their ranks
# and one int32 histogram of the N rows a warp in at most PLACE_SMEM_BYTES of
# shared memory, with at most MAX_PLACE_WARPS warps; the scan (a block a
# cloud) keeps two int32 arrays of the N rows in as much
CSR_ROWS = 2048
MAX_PLACE_WARPS = 8
PLACE_SMEM_BYTES = 200 * 1024
# the backward's launches, each alone (probe), on the scratch the launches
# before it left: the count, the scan, the place pass, the sum
PROBE_MODES = {"count": 1, "scan": 2, "place": 3, "sum": 4}


class ScatterPlan(NamedTuple):
    chunks: int  # blocks a cloud of the count and place passes (S)
    warps: int  # warps a block of the place pass
    smem_bytes: int  # shared memory of a place block


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


def gather_rows_forward(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
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


def _check_aux(values, idx, aux):
    _check(values, idx)
    if aux.dim() != 3 or tuple(aux.shape[:2]) != tuple(values.shape[:2]):
        raise ValueError(f"aux must be (B, N, C2) beside values {tuple(values.shape)}, got "
                         f"{tuple(aux.shape)}")


def gather_rows_aux_plain(values: torch.Tensor, idx: torch.Tensor, aux: torch.Tensor):
    """The plain PyTorch version of the two-table gather: two ``index_select``s."""
    _check_aux(values, idx, aux)
    return gather_rows_plain(values, idx), gather_rows_plain(aux, idx)


def gather_rows_aux(values: torch.Tensor, idx: torch.Tensor, aux: torch.Tensor):
    """values (B, N, C) float32 or bfloat16 and aux (B, N, C2) float32, gathered
    by one idx (B, M, K) -> ((B, M, K, C), (B, M, K, C2)).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if values.device.type == "cpu":
        return gather_rows_aux_plain(values, idx, aux)
    if values.device.type != "cuda":
        raise RuntimeError(f"gather_rows_aux runs on cuda or cpu tensors, got {values.device}")
    _check_aux(values, idx, aux)
    if aux.dtype != torch.float32:
        raise ValueError(f"the aux table must be float32, got {aux.dtype}")
    b, n, c = values.shape
    _, m, k = idx.shape
    c2 = aux.shape[-1]
    values, aux = values.contiguous(), aux.contiguous()
    idx = idx.to(torch.int32).contiguous()
    _build.check_cuda("gather_rows_aux", values, aux, idx)
    out = torch.empty((b, m, k, c), dtype=values.dtype, device=values.device)
    out_aux = torch.empty((b, m, k, c2), dtype=torch.float32, device=values.device)
    row_bytes = c * values.element_size()
    vec = _vec_bytes(row_bytes, values.data_ptr(), out.data_ptr())
    _build.launch("dlbt_gather_aux", _AUX_ARGTYPES, values.data_ptr(), aux.data_ptr(),
                  idx.data_ptr(), out.data_ptr(), out_aux.data_ptr(), b, m * k, n, row_bytes,
                  vec, c2, _build.stream_of(values))
    return out, out_aux


def _check_scatter(ct, idx, n):
    if ct.dim() != 4 or idx.dim() != 3 or tuple(ct.shape[:3]) != tuple(idx.shape):
        raise ValueError(f"ct must be (B, M, K, C) and idx (B, M, K), got "
                         f"{tuple(ct.shape)} and {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError("idx must be int32 or int64")
    if n < 1:
        raise ValueError(f"n={n} must be positive")


def scatter_rows_plain(ct: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The plain PyTorch version of the backward: ct (B, M, K, C), idx (B, M, K)
    -> (B, N, C) in ct's dtype.

    A stable sort of the flat keys ``b*N + idx`` lists each output row's
    contributions in ascending flat-row order; the r-th member of every
    segment is then added at once (rank by rank) into a float32 buffer, by
    gather, add and ``index_copy_`` (each row once per rank: no atomics)."""
    _check_scatter(ct, idx, n)
    b, m, k, c = ct.shape
    dev = ct.device
    ok = (idx >= 0) & (idx < n)
    base = torch.arange(b, device=dev).view(b, 1, 1) * n
    key = torch.where(ok, idx.long() + base, b * n).reshape(-1)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    keep = skey < b * n
    order, skey = order[keep], skey[keep]
    acc = torch.zeros((b * n, c), dtype=torch.float32, device=dev)
    if skey.numel():
        _, seg_len = torch.unique_consecutive(skey, return_counts=True)
        seg_start = torch.cumsum(seg_len, 0) - seg_len
        rank = torch.arange(skey.numel(), device=dev) - torch.repeat_interleave(seg_start,
                                                                               seg_len)
        by_rank = torch.argsort(rank, stable=True)  # rank 0 of every segment, then 1, ...
        per_rank = torch.bincount(rank).tolist()
        rows_flat = ct.reshape(-1, c)
        lo = 0
        for cnt in per_rank:
            sel = by_rank[lo:lo + cnt]
            lo += cnt
            dst, src = skey[sel], order[sel]
            acc.index_copy_(0, dst, acc.index_select(0, dst) + rows_flat.index_select(0, src).float())
    return acc.to(ct.dtype).view(b, n, c)


def scatter_plan(r: int, n: int) -> Optional[ScatterPlan]:
    """The backward kernel's launch for clouds of ``r`` = M*K cotangent rows
    onto ``n`` output rows (``csrc/gather_bwd.cu`` mirrors it): ceil(r /
    CSR_ROWS) blocks a cloud of the count and place passes, at least one; the
    most warps up to MAX_PLACE_WARPS whose place block fits PLACE_SMEM_BYTES.
    None where the scan's or one warp's shared memory does not fit (n beyond
    25600)."""
    if n < 1 or r < 0 or 8 * n > PLACE_SMEM_BYTES:
        return None
    warps = min(MAX_PLACE_WARPS, (PLACE_SMEM_BYTES // 4 - 2 * CSR_ROWS) // n)
    return ScatterPlan(max(1, -(-r // CSR_ROWS)), warps, 4 * (2 * CSR_ROWS + warps * n))


def _scatter_launch(ct, idx, n, scratch=None, mode=0):
    if ct.device.type != "cuda":
        raise RuntimeError(f"scatter_rows runs on cuda or cpu tensors, got {ct.device}")
    _check_scatter(ct, idx, n)
    if ct.dtype not in _DTYPE_CODES:
        raise ValueError(f"scatter_rows takes float32 or bfloat16, got {ct.dtype}")
    b, m, k, c = ct.shape
    r = m * k
    p = scatter_plan(r, n)
    if p is None:
        raise ValueError(f"scatter_rows: n={n} rows do not fit the place pass's shared memory")
    ct = ct.contiguous()
    idx = idx.to(torch.int32).contiguous()
    _build.check_cuda("scatter_rows", ct, idx)
    if scratch is None:
        i32 = dict(dtype=torch.int32, device=ct.device)
        scratch = dict(out=torch.empty((b, n, c), dtype=ct.dtype, device=ct.device),
                       # the counts, each chunk's first slots, the list's two counters
                       cnt=torch.empty((2 * b * p.chunks * n + 2,), **i32),
                       recs=torch.empty((b * n, 4), **i32),  # (row, start, end, cloud) each
                       rows=torch.empty((b, max(r, 1)), **i32))
    args = (ct.data_ptr(), idx.data_ptr(), scratch["cnt"].data_ptr(),
            scratch["recs"].data_ptr(), scratch["rows"].data_ptr(), scratch["out"].data_ptr(),
            b, r, n, c, _DTYPE_CODES[ct.dtype], p.warps)
    if mode == 0:
        _build.launch("dlbt_scatter_rows", _BWD_ARGTYPES, *args, _build.stream_of(ct))
    else:
        _build.launch("dlbt_scatter_rows_probe", _PROBE_ARGTYPES, *args, mode,
                      _build.stream_of(ct))
    return scratch


def scatter_rows(ct: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """ct (B, M, K, C) float32 or bfloat16, idx (B, M, K) -> (B, N, C) in ct's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if ct.device.type == "cpu":
        return scatter_rows_plain(ct, idx, n)
    return _scatter_launch(ct, idx, n)["out"]


def probe_scratch(ct: torch.Tensor, idx: torch.Tensor, n: int) -> dict:
    """The kernel's output and scratch after one launch on ``ct`` and ``idx``,
    for ``probe``."""
    return _scatter_launch(ct, idx, n)


def probe(ct: torch.Tensor, idx: torch.Tensor, n: int, mode: str, scratch: dict) -> None:
    """One of the kernel's launches alone, on the card, into ``scratch``
    (``probe_scratch`` of the same inputs): ``mode`` one of ``PROBE_MODES``. A
    measurement of that launch's share; no path calls it."""
    _scatter_launch(ct, idx, n, scratch, PROBE_MODES[mode])


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        ctx.n = values.shape[1]
        return gather_rows_forward(values, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return scatter_rows(ct.contiguous(), idx, ctx.n), None


class _GatherRowsAux(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx, aux):
        ctx.save_for_backward(idx)
        ctx.n = values.shape[1]
        out, out_aux = gather_rows_aux(values, idx, aux)
        ctx.mark_non_differentiable(out_aux)
        return out, out_aux

    @staticmethod
    def backward(ctx, ct, _ct_aux):
        (idx,) = ctx.saved_tensors
        return scatter_rows(ct.contiguous(), idx, ctx.n), None, None


def gather_rows(values: torch.Tensor, idx: torch.Tensor, aux: Optional[torch.Tensor] = None):
    """values (B, N, C), idx (B, M, K) -> (B, M, K, C), differentiable in values:
    the backward is ``scatter_rows``. With ``aux`` (B, N, C2) float32 it returns
    ``(gathered, gathered_aux)``, the aux rows gathered by the same index and
    carrying no gradient, as ``mxu_gather(values, idx, aux=aux)``. Without a
    gradient to take it is the forward alone."""
    grad = torch.is_grad_enabled() and values.requires_grad
    if aux is None:
        return _GatherRows.apply(values, idx) if grad else gather_rows_forward(values, idx)
    return _GatherRowsAux.apply(values, idx, aux) if grad else gather_rows_aux(values, idx, aux)
