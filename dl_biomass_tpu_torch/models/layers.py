"""Building-block layers (port of ``dl_biomass_tpu/models/layers.py``).

torch_geometric-style MLPs: per hidden layer Linear -> BatchNorm -> act ->
dropout, with a plain final Linear. Matmul inputs are cast to
``compute_dtype`` (bf16 in production) and multiplied with float32
accumulation; the float32 bias is added before the result is rounded to
``compute_dtype``, in the JAX package's order, and the gradients round where
JAX's do. BatchNorm normalizes by its running statistics in eval and by the
masked batch statistics in training.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dl_biomass_tpu_torch.ops.sa_train_kernel import fused_sa_mlp


def resolve_activation(name: Optional[str]) -> Optional[Callable]:
    """Map the reference's activation names (torch module names) to functions."""
    if name is None or name == "None":
        return None
    table = {
        "ReLU": F.relu,
        "LeakyReLU": lambda x: F.leaky_relu(x, negative_slope=0.01),
        "ELU": F.elu,
        "GELU": lambda x: F.gelu(x, approximate="tanh"),  # flax's nn.gelu default
        "Tanh": torch.tanh,
        "Sigmoid": torch.sigmoid,
    }
    if name not in table:
        raise ValueError(f"unknown activation {name!r}; options: {sorted(table)}")
    return table[name]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two 2-D operands of one dtype with a float32 product:
    bf16 x bf16 products are exact in float32, so on the card a bf16 GEMM
    with float32 output, and on the CPU a float32 product of the upcast
    operands, is JAX's ``jnp.dot(..., preferred_element_type=float32)``."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _DotF32(torch.autograd.Function):
    """The product of ``dot_f32`` with JAX's backward rounding. The cotangent
    of the float32 product comes from a compute-dtype value (the result is
    rounded to it next), so casting it to the compute dtype is exact; each
    gradient is a float32 product rounded once to its operand's dtype, as the
    transpose of ``dot_general`` with ``preferred_element_type`` rounds it."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return _mm_f32(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = _mm_f32(g, w.t()).to(x2.dtype) if ctx.needs_input_grad[0] else None
        dw = _mm_f32(x2.t(), g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., Cin) @ w (Cin, Cout)`` with float32 output, both operands in one
    compute dtype: the JAX package's ``jnp.dot(..., preferred_element_type=float32)``,
    differentiable in both."""
    shp = x.shape
    x2 = x.reshape(-1, shp[-1])
    if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
        y = _DotF32.apply(x2, w)
    else:
        y = _mm_f32(x2, w)
    return y.view(*shp[:-1], w.shape[-1])


class Dense(nn.Linear):
    """``nn.Linear`` (torch's default init, as the JAX package copies it) with
    compute-dtype matmul inputs and float32 accumulation + bias."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_features:
            raise ValueError(
                f"Dense expected {self.in_features} input features, got {x.shape[-1]}")
        cdt = self.compute_dtype
        y = dot_f32(x.to(cdt), self.weight.t().to(cdt)) + self.bias
        return y.to(cdt)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d with torch semantics over valid (mask=True) elements only:
    eps 1e-5, momentum 0.1, the biased variance to normalize and the unbiased
    one for the running estimate. ``x * scale + shift`` in float32, returned
    in the input's dtype."""

    momentum = 0.1

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def fold(self, mean: torch.Tensor, var: torch.Tensor):
        """Fold the normalize into (scale, shift): y = x*scale + shift."""
        scale = self.weight * torch.rsqrt(var + self.eps)
        return scale, self.bias - mean * scale

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor, cnt) -> None:
        """The EMA update with torch semantics (unbiased var for the running
        stat); ``cnt`` is a tensor or a float."""
        denom = torch.clamp_min(cnt - 1.0, 1.0) if torch.is_tensor(cnt) else max(cnt - 1.0, 1.0)
        unbiased = var * cnt / denom
        self.running_mean.copy_((1 - self.momentum) * self.running_mean + self.momentum * mean)
        self.running_var.copy_((1 - self.momentum) * self.running_var + self.momentum * unbiased)

    @staticmethod
    def batch_stats(xf: torch.Tensor, mask: Optional[torch.Tensor]):
        """(mean, var, cnt) of float32 ``xf`` over every axis but the last,
        valid slots only: the one-pass ``E[x^2] - mean^2``, clamped at 0, with
        ``cnt = max(sum(mask), 1)`` (the row count without a mask)."""
        axes = tuple(range(xf.dim() - 1))
        if mask is not None:
            m = mask.unsqueeze(-1).float()
            cnt = torch.clamp_min(m.sum(), 1.0)
            xm = xf * m
            mean = xm.sum(dim=axes) / cnt
            e2 = (xm * xf).sum(dim=axes) / cnt
        else:
            cnt = float(math.prod(xf.shape[:-1]))
            mean = xf.mean(dim=axes)
            e2 = (xf * xf).mean(dim=axes)
        return mean, torch.clamp_min(e2 - mean * mean, 0.0), cnt

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            mean, var, cnt = self.batch_stats(xf, mask)
            self.update_running(mean.detach(), var.detach(), cnt)
        else:
            mean, var = self.running_mean, self.running_var
        scale, shift = self.fold(mean, var)
        return (xf * scale + shift).to(x.dtype)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout`` rule, ``where(keep, x / (1 - p), 0)``, with the keep
    draws from ``generator`` on x's device."""
    if generator is None:
        raise ValueError("train-mode dropout draws from a torch.Generator: pass generator=")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class MLP(nn.Module):
    """torch_geometric-style MLP: hidden Linear->BN->act->dropout, plain final
    Linear. ``channels`` includes the input width (``[4, 64, 64, 128]`` for
    SA1); ``dropout`` > 0 (the head's) applies in training only. Submodule
    names (``lin{i}``, ``bn{i}``) follow the JAX parameter tree, so the bridge
    maps it one to one."""

    def __init__(self, channels: Sequence[int], act: Optional[str] = "ReLU",
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        chans = list(channels)
        self.act = act
        self.dropout = dropout
        self.n_lin = len(chans) - 1
        for i in range(self.n_lin):
            setattr(self, f"lin{i}", Dense(chans[i], chans[i + 1], compute_dtype))
        for i, w in enumerate(chans[1:-1]):
            setattr(self, f"bn{i}", MaskedBatchNorm(w))

    def linears(self):
        return [getattr(self, f"lin{i}") for i in range(self.n_lin)]

    def norms(self):
        return [getattr(self, f"bn{i}") for i in range(self.n_lin - 1)]

    def _post(self, x, bn, mask, act, train, generator):
        x = bn(x, mask, train)
        if act is not None:
            x = act(x)
        if train and self.dropout > 0.0:
            x = dropout(x, self.dropout, generator)
        return x

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        act = resolve_activation(self.act)
        lins, bns = self.linears(), self.norms()
        for lin, bn in zip(lins[:-1], bns):
            x = self._post(lin(x), bn, mask, act, train, generator)
        return lins[-1](x)

    def from_z0(self, z0: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Continue the stack from layer 0's pre-BN output ``z0`` (computed by the
        caller, as in SAModule's per-point first-layer split)."""
        act = resolve_activation(self.act)
        lins, bns = self.linears(), self.norms()
        if not bns:  # single-linear MLP: z0 is the output
            return z0
        x = self._post(z0, bns[0], mask, act, train, generator)
        for lin, bn in zip(lins[1:-1], bns[1:]):
            x = self._post(lin(x), bn, mask, act, train, generator)
        return lins[-1](x)


class FusedSAMLP(MLP):
    """``MLP([C0, C1, C2, C3])`` and the masked max over the 64 neighbour slots,
    run by kernel 6 (``ops/sa_train_kernel.fused_sa_mlp``). The submodules are
    ``MLP``'s (``lin0``, ``bn0``, ``lin1``, ``bn1``, ``lin2``), so the bridge,
    the checkpoints and the serving engine's folding treat it as an ``MLP``.

    ``forward(dense, planes, nbr_mask, train)``: dense (B, M, 64, CD) (cast to
    the compute type) or None, planes (B, M, 64, CP) float32 or None, W1's rows
    ``[dense..., planes...]`` -> pooled (B, M, C3) float32. Train mode uses the
    batch statistics and updates the running ones (torch EMA); eval mode uses
    the running ones. Differentiable in dense and every parameter through
    kernel 6's backward (B1-B3); the planes get no gradient."""

    def __init__(self, channels: Sequence[int], act: Optional[str] = "ReLU",
                 compute_dtype: torch.dtype = torch.float32):
        if len(channels) != 4:
            raise ValueError(f"FusedSAMLP needs [C0, C1, C2, C3] channels, got {list(channels)}")
        super().__init__(channels, act=act, compute_dtype=compute_dtype)
        self.compute_dtype = compute_dtype

    def forward(self, dense: Optional[torch.Tensor], planes: Optional[torch.Tensor],
                nbr_mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        lin0, lin1, lin2 = self.linears()
        bn0, bn1 = self.norms()
        params = dict(w1=lin0.weight.t(), b1=lin0.bias, gamma1=bn0.weight, beta1=bn0.bias,
                      w2=lin1.weight.t(), b2=lin1.bias, gamma2=bn1.weight, beta2=bn1.bias,
                      w3=lin2.weight.t(), b3=lin2.bias)
        bf16 = self.compute_dtype == torch.bfloat16
        if dense is not None:
            dense = dense.to(self.compute_dtype)
        if train:
            out, (m1, v1, m2, v2) = fused_sa_mlp(dense, planes, nbr_mask, params, act=self.act,
                                                 bf16=bf16, train=True)
            cnt = torch.clamp_min(nbr_mask.sum().float(), 1.0)
            bn0.update_running(m1, v1, cnt)
            bn1.update_running(m2, v2, cnt)
            return out
        running = (bn0.running_mean, bn0.running_var, bn1.running_mean, bn1.running_var)
        return fused_sa_mlp(dense, planes, nbr_mask, params, running, act=self.act, bf16=bf16,
                            train=False)
