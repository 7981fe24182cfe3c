"""Masked reductions (port of ``dl_biomass_tpu/ops/pooling.py``).

``masked_max`` stands in for PointConv's scatter-max aggregation and for
``global_max_pool``: with dense ``(B, N, C)`` batching the segments become a
max over the point axis with -inf masking. Its gradient goes to the first
argmax only, as torch_scatter's scatter_max backward and the JAX package's
custom VJP send it (ties come from duplicated points).
"""

from __future__ import annotations

import torch


def _expand(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.unsqueeze(-1) if mask.dim() == x.dim() - 1 else mask


def _max_only(x: torch.Tensor, mask: torch.Tensor, dim: int):
    """(filled, raw max of filled, any_valid, masked max with 0 on empty rows)."""
    filled = x.masked_fill(~_expand(mask, x), float("-inf"))
    raw = filled.amax(dim=dim)
    any_valid = _expand(mask.any(dim=dim), raw)
    zero = torch.zeros((), dtype=raw.dtype, device=raw.device)
    return filled, raw, any_valid, torch.where(any_valid, raw, zero)


def first_argmax(filled: torch.Tensor, out_max: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first entry along ``dim`` equal to the max (``out_max``,
    the max with ``dim`` reduced), built from ``filled == max`` and the
    smallest index: the tie rule does not rest on the backend's argmax. An
    entry that never equals the max (a NaN row) gives index 0."""
    k = filled.shape[dim]
    itype = torch.int16 if k < 2**15 else torch.int32
    shape = [1] * filled.dim()
    shape[dim] = k
    lane = torch.arange(k, dtype=itype, device=filled.device).view(shape)
    am = torch.where(filled == out_max.unsqueeze(dim), lane, k).amin(dim=dim)
    return torch.where(am == k, 0, am)


class _MaskedMax(torch.autograd.Function):
    """Forward: max and first-index argmax of the filled tensor, 0 on rows
    with no valid entry. Backward: ``g`` (0 on those rows), cast to x's
    dtype, at the argmax slot; every other slot gets 0."""

    @staticmethod
    def forward(ctx, x, mask, dim):
        filled, raw, any_valid, out = _max_only(x, mask, dim)
        am = first_argmax(filled, raw, dim)
        ctx.save_for_backward(am, any_valid)
        ctx.dim, ctx.shape, ctx.dtype = dim, x.shape, x.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        am, any_valid = ctx.saved_tensors
        dim = ctx.dim
        g = torch.where(any_valid, g, torch.zeros((), dtype=g.dtype, device=g.device))
        dx = torch.zeros(ctx.shape, dtype=ctx.dtype, device=g.device)
        dx.scatter_(dim, am.long().unsqueeze(dim), g.to(ctx.dtype).unsqueeze(dim))
        return dx, None, None


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Max over ``dim`` ignoring mask=False entries; 0 where a row has no valid entry.

    Without a gradient to take (``torch.no_grad``, inference mode, or an x
    that needs none) it is one reduction; otherwise the forward also keeps
    the first-index argmax for the backward."""
    if dim < 0:
        dim += x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaskedMax.apply(x, mask, dim)
    return _max_only(x, mask, dim)[3]


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean over ``dim`` ignoring mask=False entries (0 where empty)."""
    m = _expand(mask, x)
    s = torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device)).sum(dim=dim)
    cnt = m.to(x.dtype).sum(dim=dim)
    return torch.where(cnt > 0, s / cnt.clamp_min(1.0), torch.zeros((), dtype=s.dtype,
                                                                    device=s.device))
